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
    """``table[ids]``. A DTensor table sharded over "model" on its vocab
    dim is read on each rank's slice: the rows a rank holds, zeros for the
    others, a partial sum over "model" that the caller's ``constrain``
    reduces; each rank's gradient is its slice of the table's."""
    if not regions.is_dtensor(table):
        return table[ids]
    mesh = table.device_mesh
    split, lo = regions.model_slice(mesh, table.shape[0])
    rows = (regions.entry(regions.batch_axes(mesh, ids.shape[0])),) \
        + (None,) * (ids.ndim - 1)

    def local(t, i):
        if not split:
            return t[i]
        j = i - lo
        own = (j >= 0) & (j < t.shape[0])
        return torch.where(own[..., None], t[torch.where(own, j, 0)], 0.0)

    return regions.run_local(
        local, mesh, [regions.place(mesh, ("model" if split else None,
                                           None)),
                      regions.place(mesh, rows)],
        regions.place(mesh, rows + (None,),
                      partial=("model",) if split else ()), table, ids)


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


class _VocabParallelNLL(torch.autograd.Function):
    """Each row's ``logsumexp - gold`` from one rank's slice of the vocab
    (columns ``lo`` to ``lo + V_local``; Megatron's vocab-parallel
    cross-entropy): the row max, the sum of exponentials and the gold
    logit (from the rank whose slice holds the label) are all-reduced over
    ``group``, so no rank holds a row over the whole vocab. Columns at or
    past ``vocab_size`` are -1e9, as the plain path masks them. The
    backward needs no collective: a rank's gradient is its slice of
    ``softmax - onehot``, recomputed from the saved logits and the row's
    log-sum-exp."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, vocab_size: int, group):
        import torch.distributed._functional_collectives as funcol

        def reduce(t, op):
            if group is None:
                return t
            return funcol.wait_tensor(funcol.all_reduce(t, op, group))

        x = _mask_tail(logits.to(torch.float32, copy=True), lo, vocab_size)
        m = reduce(x.amax(dim=-1), "max")
        tgt = labels.clamp_min(0).long() - lo
        own = (tgt >= 0) & (tgt < x.shape[-1])
        tgt = torch.where(own, tgt, 0)
        gold = reduce(torch.where(
            own, x.gather(-1, tgt[..., None])[..., 0], 0.0), "sum")
        # in place: one float32 copy of the slice at a time
        se = reduce(x.sub_(m[..., None]).exp_().sum(dim=-1), "sum")
        lse = torch.log(se) + m
        ctx.save_for_backward(logits, lse, tgt, own)
        ctx.lo, ctx.vocab_size = lo, vocab_size
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, tgt, own = ctx.saved_tensors
        p = _mask_tail(logits.to(torch.float32, copy=True), ctx.lo,
                       ctx.vocab_size)
        p.sub_(lse[..., None]).exp_()
        p.scatter_add_(-1, tgt[..., None], -own.float()[..., None])
        return p.mul_(g[..., None]).to(logits.dtype), None, None, None, None


def _mask_tail(x: torch.Tensor, lo: int, vocab_size: int) -> torch.Tensor:
    """``x`` (a float32 copy of a slice of the vocab starting at column
    ``lo``) with the columns at or past ``vocab_size`` set to -1e9 in
    place."""
    if lo + x.shape[-1] <= vocab_size:
        return x
    col = lo + torch.arange(x.shape[-1], device=x.device)
    return x.masked_fill_(col >= vocab_size, -1e9)


def _sharded_nll(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Each row's nll of a DTensor's logits, computed on each rank's rows
    and, where "model" divides the vocab dim, on each rank's slice of the
    vocab (``_VocabParallelNLL``); the logits are never gathered."""
    mesh = logits.device_mesh
    dp = regions.entry(regions.batch_axes(mesh, logits.shape[0]))
    rows = (dp,) + (None,) * (labels.ndim - 1)
    split, lo = regions.model_slice(mesh, logits.shape[-1])
    group = mesh["model"] if split else None

    def local(lg, lb):
        return _VocabParallelNLL.apply(lg, lb, lo, vocab_size, group)

    return regions.run_local(
        local, mesh, [regions.place(mesh, rows + ("model" if split
                                                  else None,)),
                      regions.place(mesh, rows)],
        regions.place(mesh, rows), logits, labels)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy; ignores label == -1 and padded vocab tail.
    Sharded logits keep their vocab dim sharded over "model"
    (``_sharded_nll``)."""
    if regions.is_dtensor(logits):
        nll = _sharded_nll(logits, labels, vocab_size)
    else:
        logits = logits.float()
        # mask padded vocab entries so they never receive probability mass
        if logits.shape[-1] > vocab_size:
            neg = logits.new_full(
                (*logits.shape[:-1], logits.shape[-1] - vocab_size), -1e9)
            logits = torch.cat([logits[..., :vocab_size], neg], dim=-1)
        nll = _token_nll(logits, labels)
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
