"""Shared building blocks GNMT uses: inits and the token cross-entropy.

Inits draw from a ``torch.Generator``; they follow ``repro.models.layers``'
distributions but not its numbers (``jax.random`` draws differently), so
parity with the JAX package goes through converted parameters.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def dense_init(shape: Tuple[int, ...], generator: torch.Generator,
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * std).to(dtype)


def embed_init(shape: Tuple[int, ...], generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=generator,
                        device=generator.device) * 0.02).to(dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy; ignores label == -1 and padded vocab tail."""
    logits = logits.float()
    # mask padded vocab entries so they never receive probability mass
    if logits.shape[-1] > vocab_size:
        neg = logits.new_full(
            (*logits.shape[:-1], logits.shape[-1] - vocab_size), -1e9)
        logits = torch.cat([logits[..., :vocab_size], neg], dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
