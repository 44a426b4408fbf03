"""The port's CUDA kernels on the card, each against its plain version,
and the engine through them. Every test here is marked `cuda` and skips
without a card; the file imports no JAX, so on the card it runs as

    python -m pytest -m cuda tests/test_torch_cuda.py

f32 tolerance 2e-4 (the JAX suite's attention tolerance); bf16 2e-2,
because the plain version rounds its logits and its output to bf16
(each ~2^-8 relative) where the kernel keeps them in f32."""
import numpy as np
import pytest
import torch

from _torch_parity import attn_fixture, cuda_device  # noqa: F401
from _torch_parity import paged_from_dense
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.prefill_attention import ops as pre
from repro_torch.kernels.prefill_attention import ref as pre_ref

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
KINDS = ["decode", "paged_decode", "prefill", "paged_prefill"]


def _case(kind, g, window, dtype, dev):
    """(kernel call, plain call) for one kernel on seeded inputs."""
    c = None if "decode" in kind else 8
    q, k, v = attn_fixture(7, 4, 2, g, 64, 64, c=c)
    lens = np.array([1, 17, 40, 64 - (c or 0)], np.int32)
    kp, vp, tables, spare = paged_from_dense(k, v, 16, 8)
    for bi, ln in enumerate(lens):
        tables[bi, -(-(ln + (c or 0)) // 16):] = spare
    t = {n: torch.from_numpy(a).to(dev) for n, a in dict(
        q=q, k=k, v=v, kp=kp, vp=vp, tables=tables, lens=lens).items()}
    for n in ("q", "k", "v", "kp", "vp"):
        t[n] = t[n].to(dtype)
    args = {"decode": (dec.gqa_decode, dec_ref.decode_attention_ref,
                       ("q", "k", "v", "lens")),
            "paged_decode": (dec.gqa_decode_paged,
                             dec_ref.paged_decode_attention_ref,
                             ("q", "kp", "vp", "tables", "lens")),
            "prefill": (pre.gqa_prefill, pre_ref.prefill_attention_ref,
                        ("q", "k", "v", "lens")),
            "paged_prefill": (pre.gqa_prefill_paged,
                              pre_ref.paged_prefill_attention_ref,
                              ("q", "kp", "vp", "tables", "lens"))}[kind]
    fn, plain, names = args
    xs = [t[n] for n in names]
    return (lambda: fn(*xs, window=window),
            lambda: plain(*xs, window=window).float())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("g,window,dtype", [
    (1, 0, torch.float32), (4, 24, torch.float32), (1, 0, torch.bfloat16),
    (4, 24, torch.bfloat16)])
def test_kernel_matches_plain(kind, g, window, dtype, cuda_device):
    fn = {"decode": dec.gqa_decode, "paged_decode": dec.gqa_decode_paged,
          "prefill": pre.gqa_prefill,
          "paged_prefill": pre.gqa_prefill_paged}[kind]
    run, plain = _case(kind, g, window, dtype, cuda_device)
    before = fn.launches
    got = run()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.is_cuda
    assert fn.launches == before + 1
    torch.testing.assert_close(got, plain(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_idle_decode_row_is_zero(cuda_device):
    """A slot of length 0 attends nothing: the kernel returns 0 there
    (the engine discards the row)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_fixture(1, 2, 2, 1, 32, 64))
    out = dec.gqa_decode(q, k, v, torch.tensor([0, 5], dtype=torch.int32,
                                               device=cuda_device))
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(
        out[1], dec_ref.decode_attention_ref(q, k, v, 5)[1], rtol=TOL[
            torch.float32], atol=TOL[torch.float32])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_fixture(2, 2, 2, 1, 32, 64))
    with pytest.raises(ValueError, match="dtype"):
        dec.gqa_decode(q.half(), k.half(), v.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        dec.gqa_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                       v, 3)
    with pytest.raises(ValueError, match="head dim"):
        dec.gqa_decode(q[..., :32].contiguous(), k[..., :32].contiguous(),
                       v[..., :32].contiguous(), 3)


def test_engine_paged_equals_dense_on_card(cuda_device):
    """The reduced model serves one trace through the paged kernels and
    through the dense ones: the same tokens and bills, and each run
    launched its own pair of kernels once per layer and step."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api as M
    from repro_torch.nn import init_params
    from repro_torch.schemes.radio import Radio
    from repro_torch.serve import ServeEngine, make_trace

    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = init_params(M.param_specs(cfg), torch.Generator(
        device=cuda_device).manual_seed(0), cuda_device)
    trace = make_trace(2, 6, prompt_lens=(3, 40), new_tokens=(2, 6))
    fns = [dec.gqa_decode, dec.gqa_decode_paged, pre.gqa_prefill,
           pre.gqa_prefill_paged]
    reps = {}
    for kv in ("paged", "dense"):
        for f in fns:
            f.launches = 0
        reps[kv] = ServeEngine(cfg, params, n_slots=3, greedy=True, kv=kv,
                               radio=Radio(snr_db=10.0),
                               device=cuda_device).serve(trace)
        n = [f.launches for f in fns]
        on = (1, 3) if kv == "paged" else (0, 2)
        assert all(n[i] > 0 and n[i] % cfg.n_layers == 0 for i in on), n
        assert all(n[i] == 0 for i in range(4) if i not in on), n
    rows = [[(r.rid, r.tokens, r.bits, r.energy_j, r.n_tx)
             for r in rep.results] for rep in reps.values()]
    assert rows[0] == rows[1]
