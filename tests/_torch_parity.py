"""Shared helpers of the port's tests (tests/test_torch_*.py). Imports
no JAX, so the tests that run on the card can use it there."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; skips on a host without one
    (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def attn_fixture(seed, b, hkv, g, s, hd, c=None):
    """Seeded f32 (q, k, v): q [b, hkv*g, hd] (decode) or
    [b, c, hkv*g, hd] (prefill chunk), caches [b, hkv, s, hd]."""
    rng = np.random.default_rng(seed)
    qshape = (b, hkv * g, hd) if c is None else (b, c, hkv * g, hd)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    return q, k, v


def paged_from_dense(k, v, page, seed):
    """Scatter a dense cache into a shuffled pool with one spare
    (garbage) page. Returns (k_pool, v_pool, tables, spare page id);
    callers point table entries past a row's used pages at the spare
    page: placeholder entries that must never contribute."""
    b, hkv, s, hd = k.shape
    n_lp = s // page
    rng = np.random.default_rng(seed)
    n_pages = b * n_lp + 1
    perm = rng.permutation(n_pages)
    kp = rng.standard_normal((n_pages, hkv, page, hd)).astype(np.float32) * 50
    vp = rng.standard_normal((n_pages, hkv, page, hd)).astype(np.float32) * 50
    tables = np.zeros((b, n_lp), np.int32)
    for bi in range(b):
        for j in range(n_lp):
            pid = perm[bi * n_lp + j]
            tables[bi, j] = pid
            kp[pid] = k[bi, :, j * page:(j + 1) * page]
            vp[pid] = v[bi, :, j * page:(j + 1) * page]
    return kp, vp, tables, perm[-1]


def functional_adamw(grads, mu, nu, params, step, lr, b1=0.9, b2=0.95,
                     eps=1e-8, weight_decay=0.0):
    """AdamW's update as a functional expression over flat {name: leaf}
    trees, every product and sum its own rounded operation: the
    reference the in-place update is held to bit for bit. Returns
    (params, mu, nu), all new tensors."""
    mu = {k: b1 * mu[k] + (1 - b1) * grads[k] for k in mu}
    nu = {k: b2 * nu[k] + (1 - b2) * grads[k] * grads[k] for k in nu}
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
    out = {}
    for k, w in params.items():
        mhat = mu[k] / bc1.to(w.device)
        nhat = nu[k] / bc2.to(w.device)
        out[k] = w - lr * (mhat / (torch.sqrt(nhat) + eps)
                           + weight_decay * w)
    return out, mu, nu


def same_bits(a, b) -> bool:
    """Equal f32 bit patterns (`torch.equal` takes -0.0 for +0.0)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_adamw_in_place(shapes, seed, device, weight_decay, steps=3):
    """`optim.adamw`'s update over `steps` steps on f32 leaves {name:
    shape} on `device`: normal weights and gradients, -0.0, +0.0 and
    subnormal gradient entries among them. Weights, mu and nu must be
    the functional expression's bits, in the storage they came in, and
    the gradients untouched."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(seed)

    def leaf(shape):
        a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        flat = a.reshape(-1)
        pick = rng.permutation(flat.size)[:max(3, flat.size // 8)]
        flat[pick[0::3]] = -0.0
        flat[pick[1::3]] = 0.0
        flat[pick[2::3]] = np.float32(3e-41) * np.sign(flat[pick[2::3]])
        return torch.from_numpy(a).to(device)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device) for k, s in shapes.items()}
    grads = [{k: leaf(s) for k, s in shapes.items()} for _ in range(steps)]
    kept = [{k: v.clone() for k, v in g.items()} for g in grads]
    ref = {k: v.clone() for k, v in params.items()}
    ref_mu = {k: torch.zeros_like(v) for k, v in params.items()}
    ref_nu = {k: torch.zeros_like(v) for k, v in params.items()}
    init, update = adamw(weight_decay=weight_decay)
    st = init(params)

    def ptrs():
        return [t.data_ptr() for tree in (params, st.mu, st.nu)
                for t in tree.values()]
    before = ptrs()
    for s, g in enumerate(grads, 1):
        params, st = update(g, st, params, 1e-3)
        ref, ref_mu, ref_nu = functional_adamw(
            g, ref_mu, ref_nu, ref, s, 1e-3, weight_decay=weight_decay)
    assert st.step == steps and ptrs() == before
    for got, want in ((params, ref), (st.mu, ref_mu), (st.nu, ref_nu)):
        for k in shapes:
            assert same_bits(got[k], want[k]), k
    for g, k in zip(grads, kept):
        assert all(same_bits(g[n], k[n]) for n in shapes)
