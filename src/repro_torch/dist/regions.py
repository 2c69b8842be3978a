"""Local regions of a sharded forward: where a DTensor becomes the local
shard of each rank, a plain function runs on those shards, and its results
become DTensors again (``torch.distributed.tensor.experimental.local_map``).

The four hand-written kernels launch through ``ctypes`` on ``data_ptr()``s,
so a DTensor must never reach them; several ops the port uses have no
DTensor sharding rule (the MoE's index and scatter dispatch, ``cumsum``)
and raise rather than fall back. Each such piece runs inside a region whose
placements are what GSPMD gives the reference: heads or channels over
"model", batch over the data axes. On the CPU the plain versions run inside
the same regions.

Placements are written as specs (one entry per tensor dim, ``None``, an
axis name or a tuple of names, as ``dist.sharding``'s) plus the axes over
which a result is a partial sum still to be reduced (``partial``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def place(mesh, spec: Sequence = (), partial: Sequence[str] = ()) -> list:
    """One placement per mesh dim: ``Shard`` where ``spec`` names the dim,
    ``Partial()`` (a sum still to be taken) on the dims in ``partial``,
    ``Replicate()`` elsewhere. A mean over ranks is a sum of values the
    region has divided by their count: DTensor's backward hands a
    ``Partial("avg")`` input the whole gradient, not its share."""
    from torch.distributed.tensor import Partial

    from repro_torch.dist.axes import placements

    out = placements(spec, mesh)
    names = tuple(mesh.mesh_dim_names)
    for a in partial:
        out[names.index(a)] = Partial()
    return out


def batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The data axes ("pod", "data") of ``mesh`` when they divide
    ``batch``, else ``()`` (the batch is replicated)."""
    from repro_torch.dist.axes import mesh_extent

    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    if dp and batch % mesh_extent(mesh, dp) == 0:
        return dp
    return ()


def entry(axes: Sequence[str]):
    """A spec entry for ``axes``: ``None``, one name or a tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def model_size(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index("model")) if "model" in names else 1


def split_entries(x, dim: int):
    """A DTensor's mesh and the spec entries a region gives it: its batch
    (dim 0) over the data axes when they divide it, and its ``dim`` (heads
    or channels) over "model" when that degree divides it."""
    mesh = x.device_mesh
    tp = model_size(mesh)
    dp = entry(batch_axes(mesh, x.shape[0]))
    return mesh, dp, "model" if tp > 1 and x.shape[dim] % tp == 0 else None


def model_rank(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.get_local_rank(names.index("model")) \
        if "model" in names else 0


def model_slice(mesh, n: int) -> Tuple[bool, int]:
    """Whether "model" splits a dim of size ``n`` on ``mesh`` (its degree
    is above 1 and divides ``n``), and this rank's first index of it."""
    tp = model_size(mesh)
    if tp <= 1 or n % tp:
        return False, 0
    return True, model_rank(mesh) * (n // tp)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous. A gradient
    leaving a region keeps the local strides the region's backward gave it
    (a transposed einsum's, say), and DTensor's rules for the views
    upstream assume contiguous shards."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _grad_placements(ins: Sequence[Optional[list]],
                     split_dims: Sequence[int] = ()) -> tuple:
    """Where the region splits the work over a mesh dim (some input is
    sharded on it, or the dim is in ``split_dims``), an input replicated
    there gets a partial gradient from each rank, to be summed; elsewhere
    the gradient is placed as the input."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    live = [p for p in ins if p is not None]
    split = [i in split_dims or any(isinstance(p[i], Shard) for p in live)
             for i in range(len(live[0]))] if live else []
    return tuple(None if p is None else
                 [Partial() if split[i] and isinstance(q, Replicate) else q
                  for i, q in enumerate(p)] for p in ins)


def run_local(fn, mesh, ins: Sequence[Optional[list]], outs, *args,
              split: Sequence[str] = ()):
    """``fn(*local shards)`` with the inputs redistributed to ``ins`` (one
    placement list per argument, ``None`` for a non-tensor) and the results
    wrapped with ``outs`` (a placement list for one result, a tuple of them
    for several). Gradients flow through both ends: an input replicated
    over a mesh dim that the region splits gets the sum of the ranks'
    gradients (``_grad_placements``). ``split`` names the mesh dims over
    which ``fn`` splits the work though every input is whole there (each
    rank takes its own columns of a replicated weight)."""
    from torch.distributed.tensor.experimental import local_map

    def local(*xs):
        return fn(*(_ContiguousGrad.apply(x)
                    if isinstance(x, torch.Tensor) and x.requires_grad
                    else x for x in xs))

    return local_map(local, out_placements=outs, in_placements=tuple(ins),
                     in_grad_placements=_grad_placements(
                         ins, [mesh.mesh_dim_names.index(a) for a in split]),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _split_exchange(t: torch.Tensor, group, tp: int, rank: int):
    """Rank ``rank``'s local (..., 2c) slice of a tensor whose last dim
    (2F = 2 tp c, gate columns then up columns) is sharded over ``group``
    -> its gate and up columns [rank c, (rank + 1) c), each (..., c), by
    one all-to-all. Rank r holds chunks 2r and 2r + 1 of size c; chunk k is
    the gate's (k < tp) or the up's slice of rank k mod tp. So r sends each
    chunk to one rank and receives its gate chunk from rank r // 2 and its
    up chunk from rank (r + tp) // 2, in that order (the exchange's splits
    are uneven: two ranks each way). The backward is the inverse
    exchange."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd, wait_tensor)

    chunks = list(t.chunk(2, dim=-1))
    dests = [(2 * rank) % tp, (2 * rank + 1) % tp]
    if dests[0] > dests[1]:          # the chunk sent to rank 0 goes first
        chunks.reverse()
    ins = [1 if d in dests else 0 for d in range(tp)]
    outs = [0] * tp
    outs[rank // 2] += 1
    outs[(rank + tp) // 2] += 1
    recv = wait_tensor(all_to_all_single_autograd(
        torch.stack(chunks), outs, ins, group))
    return recv[0], recv[1]


def gated_product(x: torch.Tensor, w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x @ w).chunk(2, dim=-1)``: the gate and up halves of a gated
    projection (the FFN's ``wi``, mamba's ``in_proj``). A column-parallel
    ``w`` (its last dim sharded over "model") gives a product whose split
    has no DTensor sharding rule: DTensor would gather the whole product on
    every rank. Here each rank takes its batch shard of ``x`` and its
    columns of ``w`` (gathered over the data axes where FSDP shards it) and
    gets the gate and up columns of its own slice [r F/tp, (r + 1) F/tp),
    the rows of the row-parallel projection it holds, by one all-to-all
    over "model" (``_split_exchange``) of whichever has fewer rows: its
    local product (x's tokens; a decode step) or its shard of ``w`` (d
    rows; a long prefill or a training microbatch), which it then
    multiplies. Both halves come out with their batch over the data axes
    and their last dim over "model"; ``x``'s gradient is a partial sum over
    "model". Plain tensors, and a ``w`` whose last dim "model" does not
    shard, take ``chunk``."""
    if not is_dtensor(w):
        return (x @ w.to(x.dtype)).chunk(2, dim=-1)
    mesh = w.device_mesh
    names = tuple(mesh.mesh_dim_names)
    tp = model_size(mesh)
    if tp <= 1 or not w.placements[names.index("model")].is_shard(
            w.ndim - 1):
        return (x @ w.to(x.dtype)).chunk(2, dim=-1)
    if w.shape[-1] % (2 * tp):
        raise ValueError(
            f"gated_product: {tuple(x.shape)} @ {tuple(w.shape)} splits "
            f"into halves of {w.shape[-1] // 2} columns, which {tp} model "
            f"ranks do not divide")
    dp = entry(batch_axes(mesh, x.shape[0]))
    rest = (None,) * (x.ndim - 2)
    group, rank = mesh["model"], model_rank(mesh)
    out = place(mesh, (dp,) + rest + ("model",))

    def local(x, w):
        w = w.to(x.dtype)
        if x.numel() // x.shape[-1] > w.shape[0]:
            wg, wu = _split_exchange(w, group, tp, rank)
            return x @ wg, x @ wu
        return _split_exchange(x @ w, group, tp, rank)

    return run_local(local, mesh, [place(mesh, (dp,) + rest + (None,)),
                                   place(mesh, (None, "model"))],
                     (out, out), x, w)


def write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` (a decode step's cache write), with a DTensor
    ``src`` first redistributed to ``dst``'s placements: a state a region
    computed on each rank's heads goes back to the cache's own layout."""
    if is_dtensor(dst) and is_dtensor(src) \
            and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def reduce_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements. DTensor's backward leaves
    the gradient of a parameter replicated over the data axes as a partial
    sum; reduced here once, it is not reduced again by every op that reads
    it (the optimizer reads each gradient several times). Plain tensors
    pass through."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    # the parameter's shard of a dim the gradient holds whole is taken
    # first (no communication), then a sum still to take over a dim the
    # parameter is sharded on is reduce-scattered, so the other dims
    # reduce a shard, not the whole tensor
    for keep in (lambda a, q: a.is_replicate() and q.is_shard(),
                 lambda a, q: a.is_partial() and q.is_shard()):
        mid = [q if keep(a, q) else a
               for a, q in zip(g.placements, p.placements)]
        if tuple(mid) != tuple(g.placements):
            g = g.redistribute(p.device_mesh, mid)
    return g.redistribute(p.device_mesh, p.placements)


class _GradLayout(torch.autograd.Function):
    """Identity whose backward puts the gradient in the input's own
    placements: a partial sum is taken there, in the input's type
    (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        ctx.mesh = x.device_mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements \
                and not any(p.is_partial() for p in ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_layout(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient (a DTensor's) arrives in ``x``'s own
    placements. A block's normed input feeds tensor-parallel projections
    whose gradients are partial sums over "model": taken here, in the
    input's type, rather than in the norm's float32 backward at twice the
    bytes. Plain tensors pass through."""
    if is_dtensor(x) and x.requires_grad:
        return _GradLayout.apply(x)
    return x


class _ReduceOut(torch.autograd.Function):
    """A DTensor in the residual stream's layout, its batch over the data
    axes and every other dim whole (partial sums taken: one all-reduce),
    with the gradient passed back as it comes (Megatron's ``g``): each
    rank's share of the input gets the whole gradient. DTensor's own
    redistribution would hand back a partial gradient, to be reduced again
    upstream."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate, Shard

        return y.redistribute(y.device_mesh,
                              [Shard(0) if p.is_shard(0) else Replicate()
                               for p in y.placements])

    @staticmethod
    def backward(ctx, g):
        return g


def reduce_out(y: torch.Tensor) -> torch.Tensor:
    """A block's output before the residual add, in the residual stream's
    layout (batch over the data axes, the rest whole): a row-parallel
    projection's partial sum over "model" is taken by one all-reduce, as
    GSPMD lowers it, where DTensor would otherwise split it into a
    reduce-scatter and a later all-gather, and a feature-sharded output
    (RWKV's gated channel-mix) is gathered before it reaches the stream.
    Plain tensors pass through."""
    if not is_dtensor(y) or all(p.is_replicate() or p.is_shard(0)
                                for p in y.placements):
        return y
    return _ReduceOut.apply(y)


def whole_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``t`` (..., heads * dh) ready to be viewed as (..., heads, dh): a
    DTensor whose last dim is sharded over a mesh dim that does not divide
    ``heads`` (DTensor may shard a projection of replicated weights that
    way, in pieces smaller than a head) is gathered over that dim first.
    Plain tensors pass through."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    last = t.ndim - 1
    want = [Replicate() if p.is_shard(last) and heads % mesh.size(i) else p
            for i, p in enumerate(t.placements)]
    if want == list(t.placements):
        return t
    return t.redistribute(mesh, want)
