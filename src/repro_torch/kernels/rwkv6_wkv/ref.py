"""Plain PyTorch version of the WKV6 recurrence, folded-head layout.

The sequential oracle of ``repro.kernels.rwkv6_wkv.ref.wkv6_ref``, extended
as the model needs it: an optional initial state and the final state
returned beside ``y``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/lw: (BH, S, dh); u: (BH, dh); state0: (BH, dh, dh) or None
    (zeros). y_t = r_t . (S_{t-1} + u k_t v_t^T);
    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T. Computes in float32 and
    returns (y in r's type, the final state in float32)."""
    bh, s, dh = r.shape
    f32, out_dtype = torch.float32, r.dtype
    r, k, v, u = (t.to(f32) for t in (r, k, v, u))
    w = torch.exp(lw.to(f32))
    st = (torch.zeros((bh, dh, dh), dtype=f32, device=r.device)
          if state0 is None else state0.to(f32))
    ys = []
    for t in range(s):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bk,bkv->bv", rt, st)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        st = w[:, t, :, None] * st + kt[:, :, None] * vt[:, None, :]
    return torch.stack(ys, dim=1).to(out_dtype), st
