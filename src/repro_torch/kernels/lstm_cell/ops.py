"""The LSTM cell with its gradient, and the whole-sequence runner built on it.

``lstm_cell`` runs the Hopper kernel for CUDA tensors and the plain version
(``ref.py``) for CPU tensors; there is no fallback from one to the other.
The JAX package has no VJP for its kernel (GNMT's gradients there come from
XLA autodiff of the plain cell), so the backward here is PyTorch ops: it
recomputes the gate preactivations ``z`` with one matmul and forms
``dxh = dz W^T`` and ``dW = xh^T dz``. A backward kernel is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref


def _cell_fwd(xh, w, b, c):
    if xh.is_cuda:
        return kernel.lstm_cell_fwd(xh, w, b, c)
    if xh.device.type == "cpu":
        return lstm_cell_ref(xh, w, b, c)
    raise ValueError(f"lstm_cell: no kernel for device {xh.device}")


class LSTMCellFunction(torch.autograd.Function):
    """One timestep: (xh, w, b, c) -> (h_new, c_new), kernel layout."""

    @staticmethod
    def forward(ctx, xh, w, b, c):
        h_new, c_new = _cell_fwd(xh, w, b, c)
        ctx.save_for_backward(xh, w, b, c)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh, dc):
        xh, w, b, c = ctx.saved_tensors
        k, h, _ = w.shape
        z = (xh @ w.reshape(k, 4 * h)).reshape(-1, h, 4) + b
        si, sf, tg, so = (torch.sigmoid(z[..., 0]),
                          torch.sigmoid(z[..., 1] + 1.0),
                          torch.tanh(z[..., 2]), torch.sigmoid(z[..., 3]))
        tc = torch.tanh(sf * c + si * tg)
        dc_new = dc + dh * so * (1.0 - tc * tc)
        dz = torch.stack([dc_new * tg * si * (1.0 - si),
                          dc_new * c * sf * (1.0 - sf),
                          dc_new * si * (1.0 - tg * tg),
                          dh * tc * so * (1.0 - so)], dim=-1)
        dz2 = dz.reshape(-1, 4 * h)
        dxh = dz2 @ w.reshape(k, 4 * h).T
        dw = (xh.T @ dz2).reshape(k, h, 4)
        return dxh, dw, dz.sum(0), dc_new * sf


def lstm_cell(xh, w, b, c):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H) -> (h, c)."""
    return LSTMCellFunction.apply(xh, w, b, c)


def lstm_sequence(xs, h0, c0, w, b, reverse: bool = False,
                  use_kernel: bool = True):
    """xs: (B, S, D) -> hidden states (B, S, H). With ``reverse`` the scan
    runs t = S-1 ... 0 and keeps each output at its own time index, as
    ``lax.scan(..., reverse=True)`` does. ``use_kernel=False`` runs the plain
    cell under autograd instead, on any device, to compare against."""
    cell = lstm_cell if use_kernel else lstm_cell_ref
    steps = range(xs.shape[1] - 1, -1, -1) if reverse else range(xs.shape[1])
    h, c = h0, c0
    hs = [None] * xs.shape[1]
    for t in steps:
        h, c = cell(torch.cat([xs[:, t], h], dim=-1), w, b, c)
        hs[t] = h
    return torch.stack(hs, dim=1)
