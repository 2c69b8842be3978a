"""Flash attention in the models' ``(B, S, H, dh)`` layout, with its gradient.

``flash_attention`` runs the Hopper kernel for CUDA tensors, which reads q,
k and v in place (any (B, S, H) strides) and writes o contiguous, and the
plain version (``ref.py``, on heads folded into the batch) for CPU tensors;
there is no fallback from one to the other. As in the JAX package, the
backward recomputes through ``attention_ref`` and takes its VJP: the
reference has no backward kernel either.

The kernel is the op ``repro_torch::flash_attention_fwd``, so that a
fake-tensor trace follows it: its CUDA implementation is the launch
(``kernel.flash_attention_fwd``), its fake one returns o's shape and counts
``kernel.fake_calls``, and ``FlopCounterMode`` counts ``flash_flops``.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal)"
            " -> Tensor")
_LIB.impl("flash_attention_fwd", kernel.flash_attention_fwd, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd")
def _fake(q, k, v, causal):
    kernel.fake_calls += 1
    return q.new_empty(q.shape)


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


_OP = torch.ops.repro_torch.flash_attention_fwd.default


def _fold(x: torch.Tensor) -> torch.Tensor:        # (B,S,H,d) -> (BH,S,d)
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _unfold(x: torch.Tensor, b: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def _ref(q, k, v, causal: bool) -> torch.Tensor:
    return _unfold(attention_ref(_fold(q), _fold(k), _fold(v), causal),
                   q.shape[0])


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    if q.is_cuda:
        return _OP(q, k, v, causal)
    if q.device.type == "cpu":
        return _ref(q, k, v, causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """(q, k, v) in (B, S, H, dh) -> attention output, same layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _ref(q, k, v, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k/v: (B, Skv, Hkv, dh); returns (B, Sq, Hq, dh)."""
    return FlashAttentionFunction.apply(q, k, v, causal)
