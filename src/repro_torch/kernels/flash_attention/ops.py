"""Flash attention in the models' ``(B, S, H, dh)`` layout, with its gradient.

``flash_attention`` runs the Hopper kernel for CUDA tensors, which reads q,
k and v in place (any (B, S, H) strides) and writes o contiguous with each
row's log-sum-exp beside it, and the plain version (``ref.py``, on heads
folded into the batch) for CPU tensors; there is no fallback from one to
the other. The backward is routed the same way: for CUDA tensors the
backward kernel (``csrc/flash_attention_bwd.cu``), which recomputes P from
the saved log-sum-exp tile by tile and stores no S^2 tensor, for CPU
tensors the VJP of the plain version (``flash_bwd_plain``), which the
tests hold the kernel to. The JAX package has no backward kernel (its VJP
is that of its oracle).

Each kernel is an op, ``repro_torch::flash_attention_fwd`` and
``repro_torch::flash_attention_bwd``, so that a fake-tensor trace follows
it: its CUDA implementation is the launch (``kernel.flash_attention_fwd``,
``kernel.flash_attention_bwd``), its fake one returns its results' shapes
(the backward's workspace among them, so a trace holds the bytes the card
does) and counts ``kernel.fake_calls`` or ``kernel.bwd_fake_calls``, and
``FlopCounterMode`` counts ``flash_flops`` or ``flash_bwd_flops``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import plain_vjp
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref_lse

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal)"
            " -> (Tensor, Tensor)")
_LIB.impl("flash_attention_fwd", kernel.flash_attention_fwd, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd")
def _fake(q, k, v, causal):
    kernel.fake_calls += 1
    b, sq, hq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, hq, sq),
                                             dtype=torch.float32)


def flash_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs scored: key j <= query i, counted from 0 on both
    sides (top-left), when causal."""
    if not causal:
        return sq * skv
    n = min(sq, skv)
    return n * (n + 1) // 2 + (sq - n) * skv


def flash_flops(b: int, hq: int, sq: int, skv: int, dh: int,
                causal: bool) -> int:
    """4 * B * Hq * dh operations a scored pair (QK^T and PV), the count
    the card's bound takes."""
    return 4 * b * hq * dh * flash_pairs(sq, skv, causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    b, sq, hq, dh = q_shape
    return flash_flops(b, hq, sq, k_shape[1], dh, causal)


_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor lse, Tensor g, bool causal) -> (Tensor, Tensor, Tensor, "
            "Tensor)")
_LIB.impl("flash_attention_bwd", kernel.flash_attention_bwd, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_bwd")
def _fake_bwd(q, k, v, o, lse, g, causal):
    kernel.bwd_fake_calls += 1
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    work = kernel.bwd_workspace(b, hq, hkv, sq, skv, dh,
                                kernel.select_path(q.dtype, dh))
    return (q.new_empty(q.shape), k.new_empty(k.shape), k.new_empty(k.shape),
            q.new_empty((work,), dtype=torch.float32))


def flash_bwd_flops(b: int, hq: int, sq: int, skv: int, dh: int,
                    causal: bool, path: str = "tc") -> int:
    """The backward kernel's own arithmetic (``csrc/flash_attention_bwd.cu``'s
    header) and 2 * dh operations a query row for D: on the tensor-core
    path 10 * dh a scored pair (S and dP once, dV, dK, dQ in one kernel),
    on the CUDA-core path 14 * dh (S and dP in both its dK/dV and its dQ
    kernel). The card's bound takes less: the 8 * dh a pair that the
    function needs."""
    per_pair = 10 if path == "tc" else 14
    return b * hq * dh * (per_pair * flash_pairs(sq, skv, causal) + 2 * sq)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd,
                       get_raw=True)
def _bwd_flops(q, k, v, o, lse, g, causal, *args, **kwargs) -> int:
    b, sq, hq, dh = q.shape
    return flash_bwd_flops(b, hq, sq, k.shape[1], dh, causal,
                           kernel.select_path(q.dtype, dh))


_OP = torch.ops.repro_torch.flash_attention_fwd.default
_BWD_OP = torch.ops.repro_torch.flash_attention_bwd.default


def _fold(x: torch.Tensor) -> torch.Tensor:        # (B,S,H,d) -> (BH,S,d)
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _unfold(x: torch.Tensor, b: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def flash_plain(q, k, v, causal: bool = True):
    """The plain version (``ref.py``) in the (B, S, H, dh) layout, with
    the kernel's results: o (B, Sq, Hq, dh) and lse (B, Hq, Sq)."""
    b, sq, hq, _ = q.shape
    out, lse = attention_ref_lse(_fold(q), _fold(k), _fold(v), causal)
    return _unfold(out, b), lse.reshape(b, hq, sq)


# calls of ``flash_bwd_plain`` on CUDA tensors: a run on the card shows by
# a 0 here that no backward went through the plain version
plain_cuda_calls = 0


def flash_bwd_plain(q, k, v, g, causal: bool = True):
    """The VJP of ``flash_plain``'s o for the cotangent ``g``: (dq, dk,
    dv) in q's, k's and v's types. The backward kernel's yardstick and the
    CPU route of the op."""
    global plain_cuda_calls
    if q.is_cuda:
        plain_cuda_calls += 1
    return plain_vjp(lambda *t: (flash_plain(*t, causal)[0], None),
                     (q, k, v), g)


def _forward(q, k, v, causal: bool):
    if q.is_cuda:
        return _OP(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_plain(q, k, v, causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def _backward(q, k, v, o, lse, g, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.is_cuda:
        return _BWD_OP(q, k, v, o, lse, g.contiguous(), causal)[:3]
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, g, causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """(q, k, v) in (B, S, H, dh) -> attention output, same layout; saves
    o and the rows' log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        return (*_backward(*ctx.saved_tensors, g, ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k/v: (B, Skv, Hkv, dh); returns (B, Sq, Hq, dh)."""
    return FlashAttentionFunction.apply(q, k, v, causal)
