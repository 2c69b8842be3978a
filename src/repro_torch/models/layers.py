"""Shared building blocks: inits, norms, RoPE and the token cross-entropy.

Inits draw from a ``torch.Generator``; they follow ``repro.models.layers``'
distributions but not its numbers (``jax.random`` draws differently), so
parity with the JAX package goes through converted parameters.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import regions
from repro_torch.dist.axes import constrain

VOCAB_MULTIPLE = 128


def padded_vocab(vocab_size: int, multiple: int = VOCAB_MULTIPLE) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def pad_heads(num_heads: int, degree: int) -> int:
    """Pad a head count up to a multiple of the tensor-parallel degree, so
    every shard holds whole heads. The padded heads are ordinary heads with
    their own weights, as in the reference."""
    return ((num_heads + degree - 1) // degree) * degree


class MetaGenerator:
    """Stands in for a ``torch.Generator`` when a model is built on the
    ``meta`` device, which has shapes and dtypes but no numbers (torch has
    no generator there)."""

    device = torch.device("meta")


def make_generator(device: torch.device, seed: int):
    """A generator on ``device`` seeded with ``seed`` (a ``MetaGenerator``
    on the ``meta`` device)."""
    if device.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def _randn(shape: Tuple[int, ...], generator) -> torch.Tensor:
    if isinstance(generator, MetaGenerator):
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device)


def dense_init(shape: Tuple[int, ...], generator: torch.Generator,
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (_randn(shape, generator) * std).to(dtype)


def embed_init(shape: Tuple[int, ...], generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (_randn(shape, generator) * 0.02).to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; a DTensor table goes through ``F.embedding``, whose
    sharding rule takes a vocab-sharded table (the same rows and
    gradient)."""
    from torch.distributed.tensor import DTensor

    if isinstance(table, DTensor):
        return F.embedding(ids, table)
    return table[ids]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Computes in float32 and casts back to ``x``'s type."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Computes in float32 (biased variance) and casts back to ``x``'s
    type."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S). Rotates the
    two halves of the head dimension (not interleaved pairs)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., :, None, None].float() * freqs  # (...,S,1,dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return logz - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy; ignores label == -1 and padded vocab tail.
    Sharded logits gather their vocab dim first (the label lookup has no
    rule for a vocab-sharded operand)."""
    logits = constrain(logits.float(), "dp", *([None] * (logits.ndim - 1)))
    # mask padded vocab entries so they never receive probability mass
    if logits.shape[-1] > vocab_size:
        neg = logits.new_full(
            (*logits.shape[:-1], logits.shape[-1] - vocab_size), -1e9)
        logits = torch.cat([logits[..., :vocab_size], neg], dim=-1)
    if regions.is_dtensor(logits):
        # on each rank's rows: the gather's backward on a DTensor makes
        # zeros of the whole batch's logits on every rank
        mesh = logits.device_mesh
        dp = regions.entry(regions.batch_axes(mesh, logits.shape[0]))
        rows = (dp,) + (None,) * (labels.ndim - 1)
        nll = regions.run_local(
            _token_nll, mesh, [regions.place(mesh, rows + (None,)),
                               regions.place(mesh, rows)],
            regions.place(mesh, rows), logits, labels)
    else:
        nll = _token_nll(logits, labels)
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
