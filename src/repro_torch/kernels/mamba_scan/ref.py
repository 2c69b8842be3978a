"""Plain PyTorch version of the Mamba-1 selective scan.

The sequential oracle of ``repro.kernels.mamba_scan.ref.mamba_scan_ref``,
extended as the model needs it: an optional initial state, the final state
returned beside ``y``, and ``y`` kept in float32 (the model gates it with
``silu(z)`` before casting to the compute type).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def mamba_scan_ref(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/delta: (B, S, D); a: (D, N); b/c: (B, S, N); d: (D,); state0:
    (B, D, N) or None (zeros). h_t = exp(delta_t a) h_{t-1} + (delta_t x_t)
    b_t; y_t = <h_t, c_t> + d x_t. Computes in float32 and returns (y, the
    final state), both float32."""
    f32 = torch.float32
    x, delta, a, b, c, d = (t.to(f32) for t in (x, delta, a, b, c, d))
    bsz, s, dim = x.shape
    h = (torch.zeros((bsz, dim, a.shape[1]), dtype=f32, device=x.device)
         if state0 is None else state0.to(f32))
    ys = []
    for t in range(s):
        dt, xt = delta[:, t], x[:, t]
        da = torch.exp(dt[..., None] * a)
        dbx = (dt * xt)[..., None] * b[:, t, None, :]
        h = da * h + dbx
        ys.append((h * c[:, t, None, :]).sum(-1) + d * xt)
    return torch.stack(ys, dim=1), h
