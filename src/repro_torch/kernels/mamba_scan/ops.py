"""The selective scan in the model's layouts, with its gradient.

``mamba_scan`` runs the Hopper kernel for CUDA tensors and the plain version
(``ref.py``) for CPU tensors; there is no fallback from one to the other. As
in the JAX package, the backward recomputes through the plain version and
takes its VJP: the reference has no backward kernel either.

The kernel is the op ``repro_torch::mamba_scan_fwd``, so that a fake-tensor
trace follows it: its CUDA implementation is the launch
(``kernel.mamba_scan_fwd``), its fake one returns y's and the final state's
shapes and counts ``kernel.fake_calls``, and ``FlopCounterMode`` counts
``mamba_scan_flops``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("mamba_scan_fwd(Tensor x, Tensor delta, Tensor a, Tensor b, "
            "Tensor c, Tensor d, Tensor? state0) -> (Tensor, Tensor)")
_LIB.impl("mamba_scan_fwd", kernel.mamba_scan_fwd, "CUDA")


@torch.library.register_fake("repro_torch::mamba_scan_fwd")
def _fake(x, delta, a, b, c, d, state0):
    kernel.fake_calls += 1
    bsz, _, dim = x.shape
    f32 = torch.float32
    return (x.new_empty(x.shape, dtype=f32),
            x.new_empty((bsz, dim, a.shape[1]), dtype=f32))


def mamba_scan_flops(b: int, s: int, d: int, n: int) -> int:
    """6 fp32 operations per (b, t, d, n) and 3 per (b, t, d), plus one exp
    per (b, t, d, n): the counts the card's bound takes."""
    return b * s * d * (6 * n + 3) + b * s * d * n


@register_flop_formula(torch.ops.repro_torch.mamba_scan_fwd)
def _flops(x_shape, delta_shape, a_shape, *args, **kwargs) -> int:
    b, s, d = x_shape
    return mamba_scan_flops(b, s, d, a_shape[1])


_OP = torch.ops.repro_torch.mamba_scan_fwd.default


def _forward(x, delta, a, b, c, d, state0):
    if x.is_cuda:
        return _OP(x, delta, a, b, c, d, state0)
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
