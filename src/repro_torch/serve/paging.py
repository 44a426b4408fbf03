"""Host-side page allocator for the paged KV cache — the port of
`repro/serve/paging.py` (pure Python, unchanged).

The device side is a shared pool `[L, n_pages, Hkv, page_size, hd]`
(repro_torch/models/transformer.init_paged_cache) with per-slot page tables mapping
logical cache columns onto pool pages; this module owns WHICH pages a
slot holds. Allocation is deterministic — lowest free id first — so a
replayed trace walks the identical page sequence and the engine's
bit-for-bit replay guarantee extends to paged mode.

A request needs ceil((prompt_len + max_new_tokens - 1) / page_size)
pages (the highest column it ever writes is prompt+new-2); the engine
reserves them all at admission, which makes capacity-bounded admission
trivially deadlock-free: an admitted request can always finish, and the
queue head waits until completions free enough pages. Page 0 of a
brand-new table row is a PLACEHOLDER for never-written logical pages;
whatever it holds is masked by the valid-prefix length downstream.
"""
from __future__ import annotations

import heapq


class PagePool:
    """Deterministic free-list allocator over `n_pages` physical pages."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError("n_pages must be >= 1")
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages))
        heapq.heapify(self._free)
        self._held: set[int] = set()
        self.peak_pages = 0          # high-water mark of pages in use

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, free {len(self._free)}")
        pids = [heapq.heappop(self._free) for _ in range(n)]
        self._held.update(pids)
        self.peak_pages = max(self.peak_pages, self.used_pages)
        return pids

    def free(self, pids) -> None:
        for p in pids:
            if p not in self._held:
                raise RuntimeError(f"double free of page {p}")
            self._held.discard(p)
            heapq.heappush(self._free, p)


def pages_needed(prompt_len: int, max_new_tokens: int,
                 page_size: int) -> int:
    """Pages covering every column a request will write (its highest
    write is column prompt_len + max_new_tokens - 2)."""
    cols = max(1, int(prompt_len) + int(max_new_tokens) - 1)
    return -(-cols // int(page_size))


def prefill_buckets(chunk_size: int) -> tuple:
    """Power-of-two chunk buckets up to `chunk_size` (floor 4, so e.g.
    32 -> (4, 8, 16, 32)): every admission compiles against one of
    these shapes instead of one executable per distinct prompt length."""
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    top = 1 << (int(chunk_size) - 1).bit_length()
    c = min(4, top)
    out = []
    while c < top:
        out.append(c)
        c *= 2
    out.append(top)
    return tuple(out)


def bucket_for(c: int, buckets) -> int:
    """Smallest bucket >= c."""
    for b in buckets:
        if b >= c:
            return b
    raise ValueError(f"chunk {c} exceeds largest bucket {buckets[-1]}")
