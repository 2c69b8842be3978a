"""The selective scan in the model's layouts, with its gradient.

``mamba_scan`` runs the Hopper kernel for CUDA tensors and the plain version
(``ref.py``) for CPU tensors; there is no fallback from one to the other. As
in the JAX package, the backward recomputes through the plain version and
takes its VJP: the reference has no backward kernel either.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


def _forward(x, delta, a, b, c, d, state0):
    if x.is_cuda:
        return kernel.mamba_scan_fwd(x, delta, a, b, c, d, state0)
    if x.device.type == "cpu":
        return mamba_scan_ref(x, delta, a, b, c, d, state0)
    raise ValueError(f"mamba_scan: no kernel for device {x.device}")


class MambaScanFunction(torch.autograd.Function):
    """(x, delta, a, b, c, d, state0) -> (y, final state)."""

    @staticmethod
    def forward(ctx, x, delta, a, b, c, d, state0):
        ctx.save_for_backward(x, delta, a, b, c, d, state0)
        return _forward(x, delta, a, b, c, d, state0)

    @staticmethod
    def backward(ctx, gy, gs):
        inputs = [None if t is None else t.detach().requires_grad_()
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, st = mamba_scan_ref(*inputs)
        live = [t for t in inputs if t is not None]
        grads = iter(torch.autograd.grad((y, st), live, (gy, gs)))
        return tuple(None if t is None else next(grads) for t in inputs)


def mamba_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
               state0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/delta: (B, S, D); a: (D, N); b/c: (B, S, N); d: (D,); state0:
    (B, D, N) float32 or None (zeros). Returns y (B, S, D) and the final
    state (B, D, N), both float32."""
    return MambaScanFunction.apply(x, delta, a, b, c, d, state0)
