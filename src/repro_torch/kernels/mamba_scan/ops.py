"""The selective scan in the model's layouts, with its gradient.

``mamba_scan`` runs the Hopper kernels for CUDA tensors and the plain
version (``ref.py``) for CPU tensors; there is no fallback from one to the
other. The backward is routed the same way: for CUDA tensors the backward
kernel (``csrc/mamba_scan_bwd.cu``), for CPU tensors the VJP of the plain
version (``mamba_scan_bwd_plain``), which the tests hold the kernel to.
The JAX package has no backward kernel (its VJP is that of its oracle).

Each kernel is an op, ``repro_torch::mamba_scan_fwd`` and
``repro_torch::mamba_scan_bwd``, so that a fake-tensor trace follows it:
its CUDA implementation is the launch (``kernel.mamba_scan_fwd``,
``kernel.mamba_scan_bwd``), its fake one returns its results' shapes (the
backward's workspaces among them) and counts ``kernel.fake_calls`` or
``kernel.bwd_fake_calls``, and ``FlopCounterMode`` counts
``mamba_scan_flops`` or ``mamba_scan_bwd_flops``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import plain_vjp
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


_LIB.define("mamba_scan_bwd(Tensor x, Tensor delta, Tensor a, Tensor b, "
            "Tensor c, Tensor d, Tensor? state0, Tensor gy, Tensor? gs) -> "
            "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor?, "
            "Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("mamba_scan_bwd", kernel.mamba_scan_bwd, "CUDA")


@torch.library.register_fake("repro_torch::mamba_scan_bwd")
def _fake_bwd(x, delta, a, b, c, d, state0, gy, gs):
    kernel.bwd_fake_calls += 1
    bsz, s, dim = x.shape
    n = a.shape[1]
    return (x.new_empty(x.shape), delta.new_empty(delta.shape),
            a.new_empty(a.shape), b.new_empty((bsz, s, n)),
            c.new_empty((bsz, s, n)), d.new_empty(d.shape),
            None if state0 is None else state0.new_empty(state0.shape),
            *(delta.new_empty(shape)
              for shape in kernel.bwd_workspace(bsz, s, dim, n)))


def mamba_scan_bwd_flops(b: int, s: int, d: int, n: int) -> int:
    """The backward kernel's own arithmetic (``csrc/mamba_scan_bwd.cu``'s
    header), its 3 exps per (b, t, d, n) among the operations: with P =
    min(``BWD_THREADS_PER_CHANNEL``, N) threads a channel, per (b, t, d)
    24 N + 5 + P (4 + 2 log2 P + log2(16 / N)) fp32 operations, the
    blocks' and warps' partials of dB and dC (4 N P per (b, t, block)),
    and dA's and dD's sums over b."""
    blocks = -(-d // kernel.BWD_CHANNELS)
    p = min(kernel.BWD_THREADS_PER_CHANNEL, n)
    log2 = lambda x: x.bit_length() - 1  # noqa: E731
    per = 24 * n + 5 + p * (4 + 2 * log2(p) + log2(16 // n))
    return (b * s * d * per + 4 * n * p * b * s * blocks + b * d * (n + 1)
            + 3 * b * s * d * n)


@register_flop_formula(torch.ops.repro_torch.mamba_scan_bwd)
def _bwd_flops(x_shape, delta_shape, a_shape, *args, **kwargs) -> int:
    b, s, d = x_shape
    return mamba_scan_bwd_flops(b, s, d, a_shape[1])


_OP = torch.ops.repro_torch.mamba_scan_fwd.default
_BWD_OP = torch.ops.repro_torch.mamba_scan_bwd.default


def mamba_scan_bwd_plain(x, delta, a, b, c, d, state0, gy, gs=None):
    """The VJP of ``mamba_scan_ref`` with ``mamba_scan_bwd``'s arguments:
    (dx, ddelta, da, db, dc, dd, dstate0), each in its input's type,
    dstate0 None where state0 is; gs None is zeros."""
    return plain_vjp(mamba_scan_ref, (x, delta, a, b, c, d, state0), gy, gs)


def _forward(x, delta, a, b, c, d, state0):
    if x.is_cuda:
        return _OP(x, delta, a, b, c, d, state0)
    if x.device.type == "cpu":
        return mamba_scan_ref(x, delta, a, b, c, d, state0)
    raise ValueError(f"mamba_scan: no kernel for device {x.device}")


def _backward(x, delta, a, b, c, d, state0, gy, gs):
    if x.is_cuda:
        return _BWD_OP(x, delta, a, b, c, d, state0, gy.contiguous(),
                       None if gs is None else gs.contiguous())[:7]
    if x.device.type == "cpu":
        return mamba_scan_bwd_plain(x, delta, a, b, c, d, state0, gy, gs)
    raise ValueError(f"mamba_scan: no kernel for device {x.device}")


class MambaScanFunction(torch.autograd.Function):
    """(x, delta, a, b, c, d, state0) -> (y, final state)."""

    @staticmethod
    def forward(ctx, x, delta, a, b, c, d, state0):
        # an unused final state gets no cotangent (None, not zeros): the
        # kernel then reads none
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, delta, a, b, c, d, state0)
        return _forward(x, delta, a, b, c, d, state0)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(saved[1])          # delta's: y's float32
        return _backward(*saved, gy, gs)


def mamba_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
               state0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/delta: (B, S, D); a: (D, N); b/c: (B, S, N); d: (D,); state0:
    (B, D, N) float32 or None (zeros). Returns y (B, S, D) and the final
    state (B, D, N), both float32."""
    return MambaScanFunction.apply(x, delta, a, b, c, d, state0)
