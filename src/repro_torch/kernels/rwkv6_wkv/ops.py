"""WKV6 in the model's ``(B, S, H, dh)`` layout, with its gradient.

``wkv6`` runs the Hopper kernel for CUDA tensors, which reads and writes
that layout in place, and the plain version (``ref.py``, heads folded into
the batch) for CPU tensors; there is no fallback from one to the other. As
in the JAX package, the backward recomputes through the plain version and
takes its VJP: the reference has no backward kernel either.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rwkv6_wkv import kernel
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref


def _fold(x: torch.Tensor) -> torch.Tensor:        # (B,S,H,d) -> (BH,S,d)
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def wkv6_plain(r, k, v, lw, u, state0):
    """The plain version (``ref.py``) in the (B, S, H, dh) layout, with
    ``wkv6``'s arguments and results."""
    b, s, h, dh = r.shape
    u_full = u.expand(b, h, dh).reshape(b * h, dh)
    s0 = None if state0 is None else state0.reshape(b * h, dh, dh)
    y, st = wkv6_ref(_fold(r), _fold(k), _fold(v), _fold(lw), u_full, s0)
    return (y.reshape(b, h, s, dh).transpose(1, 2),
            st.reshape(b, h, dh, dh))


def _forward(r, k, v, lw, u, state0):
    if r.is_cuda:
        return kernel.wkv6_fwd(r, k, v, lw, u, state0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, lw, u, state0)
    raise ValueError(f"wkv6: no kernel for device {r.device}")


class WKV6Function(torch.autograd.Function):
    """(r, k, v, lw, u, state0) -> (y, final state)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state0):
        ctx.save_for_backward(r, k, v, lw, u, state0)
        return _forward(r, k, v, lw, u, state0)

    @staticmethod
    def backward(ctx, gy, gs):
        inputs = [None if t is None else t.detach().requires_grad_()
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, st = wkv6_plain(*inputs)
        live = [t for t in inputs if t is not None]
        grads = iter(torch.autograd.grad((y, st), live, (gy, gs)))
        return tuple(None if t is None else next(grads) for t in inputs)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor,
         state0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/lw: (B, S, H, dh) float32; u: (H, dh); state0: (B, H, dh, dh)
    or None (zeros). Returns y (B, S, H, dh) and the final state."""
    return WKV6Function.apply(r, k, v, lw, u, state0)
