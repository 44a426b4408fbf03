"""Plain PyTorch version of the conv+pool kernel — the math of
`repro/kernels/conv_pool/ref.py::conv_pool_ref` (and of the user-side
partition `lstm_tiny.user_forward` after the embedding gather). The CPU
runs it; on the card it is only the kernel's yardstick."""
from __future__ import annotations

import torch


def conv_pool_ref(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x [B, T, E], w [K, E, F], b [F] -> [B, (T-K+1)//2, F]: K shifted
    f32 matmuls, bias, ReLU, MaxPool1D(2) with stride 2."""
    B, T, E = x.shape
    K, _, F = w.shape
    t_out = T - K + 1
    out = sum(x[:, k:t_out + k].float() @ w[k].float() for k in range(K))
    out = torch.relu(out + b.float())
    P = t_out // 2
    pooled = out[:, :2 * P].reshape(B, P, 2, F).amax(dim=2)
    return pooled.to(x.dtype)
