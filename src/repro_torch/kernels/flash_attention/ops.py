"""Flash attention in the models' ``(B, S, H, dh)`` layout, with its gradient.

``flash_attention`` runs the Hopper kernel for CUDA tensors, which reads q,
k and v in place (any (B, S, H) strides) and writes o contiguous, and the
plain version (``ref.py``, on heads folded into the batch) for CPU tensors;
there is no fallback from one to the other. As in the JAX package, the
backward recomputes through ``attention_ref`` and takes its VJP: the
reference has no backward kernel either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


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
        return kernel.flash_attention_fwd(q, k, v, causal)
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
