"""WKV6 in the model's ``(B, S, H, dh)`` layout, with its gradient.

``wkv6`` runs the Hopper kernels for CUDA tensors, which read and write
that layout in place, and the plain version (``ref.py``, heads folded into
the batch) for CPU tensors; there is no fallback from one to the other.
The backward is routed the same way: for CUDA tensors the backward kernel
(``csrc/wkv6_bwd.cu``), for CPU tensors the VJP of the plain version
(``wkv6_bwd_plain``), which the tests hold the kernel to. The JAX package
has no backward kernel (its VJP is that of its oracle).

Each kernel is an op, ``repro_torch::wkv6_fwd`` and
``repro_torch::wkv6_bwd``, so that a fake-tensor trace follows it: its
CUDA implementation is the launch (``kernel.wkv6_fwd``,
``kernel.wkv6_bwd``), its fake one returns its results' shapes (the
backward's workspace among them) and counts ``kernel.fake_calls`` or
``kernel.bwd_fake_calls``, and ``FlopCounterMode`` counts ``wkv6_flops``
or ``wkv6_bwd_flops``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import plain_vjp
from repro_torch.kernels.rwkv6_wkv import kernel
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("wkv6_fwd(Tensor r, Tensor k, Tensor v, Tensor lw, Tensor u, "
            "Tensor? state0) -> (Tensor, Tensor)")
_LIB.impl("wkv6_fwd", kernel.wkv6_fwd, "CUDA")


@torch.library.register_fake("repro_torch::wkv6_fwd")
def _fake(r, k, v, lw, u, state0):
    kernel.fake_calls += 1
    b, _, h, dh = r.shape
    return r.new_empty(r.shape), r.new_empty((b, h, dh, dh))


def wkv6_flops(b: int, s: int, h: int, dh: int) -> int:
    """The recurrence's 5 * dh^2 + 5 * dh operations per (b, h, t), the
    count the card's bound takes."""
    return b * h * s * (5 * dh * dh + 5 * dh)


@register_flop_formula(torch.ops.repro_torch.wkv6_fwd)
def _flops(r_shape, *args, **kwargs) -> int:
    return wkv6_flops(*r_shape)


_LIB.define("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor lw, Tensor u, "
            "Tensor? state0, Tensor gy, Tensor? gs) -> (Tensor, Tensor, "
            "Tensor, Tensor, Tensor, Tensor?, Tensor)")
_LIB.impl("wkv6_bwd", kernel.wkv6_bwd, "CUDA")


@torch.library.register_fake("repro_torch::wkv6_bwd")
def _fake_bwd(r, k, v, lw, u, state0, gy, gs):
    kernel.bwd_fake_calls += 1
    b, s, h, dh = r.shape
    return (*(r.new_empty(r.shape) for _ in range(4)), u.new_empty(u.shape),
            None if state0 is None else state0.new_empty(state0.shape),
            r.new_empty(kernel.bwd_workspace(b, s, h, dh)))


def wkv6_bwd_flops(b: int, s: int, h: int, dh: int) -> int:
    """The backward kernel's own arithmetic (``csrc/wkv6_bwd.cu``'s
    header), per (b, h) and chunk of C = 32 steps: its tensor-core
    products at 3 passes of 2 M N K, 6 (5 C dh^2 + 15 C^2 dh / 4); 84 C dh
    elementwise operations and 6 dh^2 for the walks and the boundary
    term; and du's sum over b and the chunks."""
    c = kernel.BWD_CHUNK
    per = 6 * (5 * c * dh * dh + 15 * c * c * dh // 4) + 84 * c * dh \
        + 6 * dh * dh + dh
    return b * h * -(-s // c) * (per + dh)


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def _bwd_flops(r_shape, *args, **kwargs) -> int:
    return wkv6_bwd_flops(*r_shape)


_OP = torch.ops.repro_torch.wkv6_fwd.default
_BWD_OP = torch.ops.repro_torch.wkv6_bwd.default


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


def wkv6_bwd_plain(r, k, v, lw, u, state0, gy, gs=None):
    """The VJP of ``wkv6_plain`` with ``wkv6_bwd``'s arguments and results:
    (dr, dk, dv, dlw, du, dstate0), dstate0 None where state0 is; gs None
    is zeros."""
    return plain_vjp(wkv6_plain, (r, k, v, lw, u, state0), gy, gs)


def _forward(r, k, v, lw, u, state0):
    if r.is_cuda:
        return _OP(r, k, v, lw, u, state0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, lw, u, state0)
    raise ValueError(f"wkv6: no kernel for device {r.device}")


def _backward(r, k, v, lw, u, state0, gy, gs):
    if r.is_cuda:
        return _BWD_OP(r, k, v, lw, u, state0, gy.contiguous(),
                       None if gs is None else gs.contiguous())[:6]
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, lw, u, state0, gy, gs)
    raise ValueError(f"wkv6: no kernel for device {r.device}")


class WKV6Function(torch.autograd.Function):
    """(r, k, v, lw, u, state0) -> (y, final state)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state0):
        # an unused final state gets no cotangent (None, not zeros): the
        # kernel then reads none
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, lw, u, state0)
        return _forward(r, k, v, lw, u, state0)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(saved[0])
        return _backward(*saved, gy, gs)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor,
         state0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/lw: (B, S, H, dh) float32; u: (H, dh); state0: (B, H, dh, dh)
    or None (zeros). Returns y (B, S, H, dh) and the final state."""
    return WKV6Function.apply(r, k, v, lw, u, state0)
