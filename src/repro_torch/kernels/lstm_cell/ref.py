"""Plain PyTorch version of the fused LSTM cell, in the kernel's layout."""
from __future__ import annotations

import torch


def lstm_cell_ref(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H).
    Returns (h_new, c_new), each (B, H). Computes in at least float32, as
    the kernel accumulates (float64 stays float64, for gradcheck)."""
    acc = torch.promote_types(xh.dtype, torch.float32)
    z = torch.einsum("bd,dhg->bhg", xh.to(acc), w.to(acc)) + b.to(acc)[None]
    i, f, g, o = z.unbind(-1)
    c_new = torch.sigmoid(f + 1.0) * c.to(acc) \
        + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(xh.dtype), c_new.to(xh.dtype)
