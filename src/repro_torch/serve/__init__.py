"""repro_torch.serve — continuous-batching inference over per-user Radios
(the port of `repro.serve`): `RequestTrace` is the replay format,
`ServeEngine` the slot-based serving loop with exact per-user bills,
`PagePool` the paged KV allocator."""
from repro_torch.serve.trace import (Request, RequestTrace, make_trace,
                                     uniform_trace)
from repro_torch.serve.engine import (ServeDraws, ServeEngine, ServeReport,
                                      RequestResult, SLOT_FAMILIES,
                                      PAGED_FAMILIES, SERVE_STREAM)
from repro_torch.serve.paging import (PagePool, pages_needed,
                                      prefill_buckets, bucket_for)

__all__ = [
    "Request", "RequestTrace", "make_trace", "uniform_trace",
    "ServeDraws", "ServeEngine", "ServeReport", "RequestResult",
    "SLOT_FAMILIES", "PAGED_FAMILIES", "SERVE_STREAM",
    "PagePool", "pages_needed", "prefill_buckets", "bucket_for",
]
