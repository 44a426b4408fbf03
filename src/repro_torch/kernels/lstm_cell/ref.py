"""Plain PyTorch version of the LSTM recurrence kernel — the math of
`repro/kernels/lstm_cell/ref.py::lstm_final_state_ref` (the scan of
`lstm_tiny.lstm_scan` with the input product done first). The CPU runs
it; on the card it is only the kernel's yardstick."""
from __future__ import annotations

import torch


def lstm_final_state_ref(xw: torch.Tensor, wh: torch.Tensor):
    """xw [B, T, 4H] (x @ Wx + b), wh [H, 4H] -> (h_T, c_T) [B, H] f32,
    gates in the order i, f, g, o."""
    B, T, H4 = xw.shape
    H = H4 // 4
    xw, wh = xw.float(), wh.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    c = h
    for t in range(T):
        gates = xw[:, t] + h @ wh
        i, f, g, o = torch.split(gates, H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h, c
