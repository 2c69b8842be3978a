"""Logical -> physical sharding rules keyed on parameter names, a port of
``repro.dist.sharding``.

The rule table is the reference's, keyed on the last one or two parts of a
parameter's dotted name (``layers.3.mixer.wq`` ends in ``mixer``, ``wq``):
``wq``/``wi`` are column-parallel kernels, ``wo``/``out_proj``
row-parallel, expert kernels ``e_*`` shard over experts (EP) when the
expert count divides the model degree and fall back to feature-dim TP
otherwise, and so on.

  leaf suffix              spec (trailing dims)         condition
  ----------------------   --------------------------   -----------------------
  embed                    ("model", None)              vocab % tp == 0
  lm_head                  (None, "model")
  wq / wi / s_wg / ...     (..., "model")               column-parallel
  wk / wv / bk / bv        (..., "model")               num_kv_heads % tp == 0
  w_uq / w_uk / w_uv       (..., "model")               num_heads % tp == 0
  wo / out_proj / s_wo     (..., "model", None)         row-parallel
  e_wg / e_wu / e_wo       ("model" on expert dim)      E % tp == 0 (EP)
  e_wg / e_wu (TP fall.)   (..., "model")               feature dim
  e_* (moe_full_ep)        (dp x model on expert dim)   E % (dp*tp) == 0
  norms / biases / router  replicated

FSDP (ZeRO-style) additionally shards big layer kernels over the data axis
(and the pod axis with ``fsdp_over_pods``): any non-exempt leaf whose
per-TP-shard footprint exceeds ``FSDP_MIN_BYTES`` gets the data axes on its
largest still-unsharded divisible dim. Embeddings, the LM head and position
tables are exempt.

A spec is a tuple with one entry per tensor dim, each ``None``, an axis
name or a tuple of names, as a ``PartitionSpec``; specs come from a
``MeshConfig`` alone, so they need no process group. The reference stacks
a layer stack's leaves on a leading dim for its ``lax.scan``; the port
keeps one module per layer (``layers.i``, ``enc_layers.i``,
``dec_layers.i``). So a port tensor's spec is the reference leaf's spec
without its first entry: the rules are computed on the stacked shape (the
FSDP rule weighs the whole stack's bytes, as the reference's does) and the
stacking entry is dropped. ``distribute_params``
turns the specs into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.models.layers import pad_heads

Spec = Tuple[Any, ...]

# Per-TP-shard bytes above which an FSDP-eligible leaf is data-sharded.
# Keyed on the *stored* dtype: at the production bf16 param dtype the layer
# kernels of every >3B assigned arch cross it while norm scales never do.
FSDP_MIN_BYTES = 2 ** 27  # 128 MiB

# Leaves never FSDP-sharded (see module docstring).
_FSDP_EXEMPT = ("embed", "lm_head", "enc_pos", "dec_pos")

# Leaf names sharded on the last (output/feature) dim over the model axis.
_COLUMN = ("wq", "wi", "bq", "bi", "s_wg", "s_wu", "in_proj", "conv_w",
           "conv_b", "dt_proj", "w_a2", "w_r", "w_g", "w_k")
# Leaf names sharded on dim -2 (input/feature) over the model axis.
_ROW = ("wo", "bo_row", "s_wo", "out_proj", "w_o", "w_v")
# KV projections: shard only when the kv-head count divides tp (otherwise a
# head would straddle shards; we replicate instead of splitting heads).
_KV = ("wk", "wv", "bk", "bv")
# MLA latent->per-head kernels: head-structured output dim.
_HEADED = ("w_uq", "w_uk", "w_uv")
# Expert kernels: (E, d, f) / (E, f, d).
_EXPERT_COL = ("e_wg", "e_wu")   # TP fallback shards f = last dim
_EXPERT_ROW = ("e_wo",)          # TP fallback shards f = dim -2

# the port's per-layer module lists, stacked on a leading dim in the
# reference
_STACKS = ("layers", "enc_layers", "dec_layers")


def _axes_entry(axes: Sequence[str]):
    return axes[0] if len(axes) == 1 else tuple(axes)


def _dp_axes(mesh: MeshConfig, over_pods: bool) -> Tuple[str, ...]:
    want = ("pod", "data") if over_pods else ("data",)
    return tuple(a for a in mesh.axes if a in want)


def _degree(mesh: MeshConfig, axes: Sequence[str]) -> int:
    d = 1
    for s, a in zip(mesh.shape, mesh.axes):
        if a in axes:
            d *= s
    return d


def _base_entries(names: Tuple[str, ...], shape: Tuple[int, ...],
                  cfg: ModelConfig, tp: int, moe_full_ep: bool,
                  mesh: MeshConfig) -> list:
    """Model-axis (TP/EP) entries for one leaf; one entry per dim."""
    nd = len(shape)
    entries: list = [None] * nd
    if nd == 0:
        return entries
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    # RWKV name collision: time-mix w_k/w_v (under "mixer") are column
    # kernels; channel-mix w_k (column) / w_v (row) live under "ffn". The
    # class lists above encode the ffn variant; flip for the mixer.
    if parent == "mixer" and name in ("w_v",):
        cls_row, cls_col = False, True
    else:
        cls_col = name in _COLUMN
        cls_row = name in _ROW

    def put(dim_idx: int, axes: Sequence[str]) -> None:
        deg = _degree(mesh, axes)
        if axes and deg > 1 and shape[dim_idx] % deg == 0:
            entries[dim_idx] = _axes_entry(tuple(axes))

    if tp <= 1 and not moe_full_ep:
        return entries
    has_model = "model" in mesh.axes

    if name == "embed":
        # (vocab_p, d): vocab rows over model; padded_vocab is a multiple of
        # 128 so every power-of-two tp divides it.
        if has_model and nd >= 2:
            put(nd - 2, ("model",))
        return entries
    if name == "lm_head":
        if has_model:
            put(nd - 1, ("model",))
        return entries
    if name in ("enc_pos", "dec_pos", "router") or not has_model:
        return entries

    if name in _EXPERT_COL + _EXPERT_ROW and cfg.moe is not None:
        e = cfg.moe.num_experts
        ep_axes = tuple(a for a in mesh.axes if a in ("data", "model")) \
            if moe_full_ep else ("model",)
        ep_deg = _degree(mesh, ep_axes)
        if e % ep_deg == 0 and nd >= 3:
            put(nd - 3, ep_axes)               # expert-parallel
        elif name in _EXPERT_COL:
            put(nd - 1, ("model",))            # TP fallback: shard f
        else:
            put(nd - 2, ("model",))
        return entries

    if name in _KV:
        if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0:
            put(nd - 1, ("model",))
        return entries
    if name in _HEADED:
        if cfg.num_heads and cfg.num_heads % tp == 0:
            put(nd - 1, ("model",))
        return entries
    if cls_col:
        put(nd - 1, ("model",))
        return entries
    if cls_row and nd >= 2:
        put(nd - 2, ("model",))
        return entries
    return entries


def _apply_fsdp(entries: list, names: Tuple[str, ...],
                shape: Tuple[int, ...], itemsize: int,
                mesh: MeshConfig, over_pods: bool) -> list:
    if names[-1] in _FSDP_EXEMPT:
        return entries
    dp = _dp_axes(mesh, over_pods)
    dp_deg = _degree(mesh, dp)
    if not dp or dp_deg <= 1:
        return entries
    # per-TP-shard footprint: total bytes / extent already sharded away
    sharded = 1
    for e, s in zip(entries, shape):
        if e is not None:
            sharded *= _degree(mesh, (e,) if isinstance(e, str) else e)
    size = itemsize
    for s in shape:
        size *= s
    if size // max(sharded, 1) < FSDP_MIN_BYTES:
        return entries
    # largest still-unsharded dim divisible by the dp degree
    cands = sorted((s, i) for i, (e, s) in enumerate(zip(entries, shape))
                   if e is None and s % dp_deg == 0)
    if cands:
        entries[cands[-1][1]] = _axes_entry(dp)
    return entries


def stack_depth(name: str, cfg: ModelConfig) -> int:
    """How many layers the reference stacks on the leading dim of the leaf
    that ``name`` is one slice of; 0 for a leaf that is not stacked."""
    top = name.split(".")[0]
    if top == "layers":
        return cfg.num_layers // cfg.interleave_period
    if top == "enc_layers":
        return cfg.encoder.num_layers
    if top == "dec_layers":
        return cfg.num_layers
    return 0


def _shapes(params) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """name -> (shape, itemsize) from a module or a name -> tensor map."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) \
        else params.items()
    return {n: (tuple(t.shape), t.element_size()) for n, t in items}


def param_specs(params, cfg: ModelConfig, mesh: MeshConfig,
                fsdp: bool = False, fsdp_over_pods: bool = False,
                moe_full_ep: bool = False,
                parallelism: str = "tp") -> Dict[str, Spec]:
    """Parameter name -> spec, for a module (a model on the ``meta``
    device will do) or a name -> tensor map.

    ``parallelism="dp_only"`` replicates every parameter (the whole mesh is
    the batch); FSDP may still storage-shard big kernels over the data
    axes. Where the reference's FSDP rule shards a layer stack over its
    stacking dim (a small leaf below ``FSDP_MIN_BYTES`` lowered, whose
    largest divisible dim is the stack), the port's per-layer tensor stays
    whole on the data axes: one module per layer cannot hold a slice of
    the stack. That only moves storage, never a value; at the production
    threshold no leaf of any arch does it.
    """
    tp = mesh.model_degree if parallelism == "tp" else 1
    out: Dict[str, Spec] = {}
    for name, (shape, itemsize) in _shapes(params).items():
        names = tuple(name.split("."))
        n = stack_depth(name, cfg)
        full = ((n,) if n else ()) + shape
        entries = _base_entries(names, full, cfg, tp, moe_full_ep, mesh)
        if fsdp:
            entries = _apply_fsdp(entries, names, full, itemsize, mesh,
                                  fsdp_over_pods)
        if n:
            entries = entries[1:]
        out[name] = tuple(entries)
    return out


def batch_specs(batch: Mapping[str, Any], mesh: MeshConfig,
                shape: ShapeConfig, parallelism: str = "tp"
                ) -> Dict[str, Spec]:
    """Batch inputs shard dim 0 over the data axes (the whole mesh under
    ``dp_only``) when the global batch divides; otherwise replicate."""
    if parallelism == "dp_only":
        dp = mesh.axes
    else:
        dp = tuple(a for a in mesh.axes if a in ("pod", "data"))
    deg = _degree(mesh, dp)

    def one(leaf) -> Spec:
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        if deg > 1 and leaf.shape[0] % deg == 0:
            return (_axes_entry(dp),) + (None,) * (nd - 1)
        return (None,) * nd

    return {k: one(v) for k, v in batch.items()}


def cache_specs(cache, cfg: ModelConfig, mesh: MeshConfig,
                shape: ShapeConfig):
    """Decode caches, the structure of ``init_cache`` (one entry per layer)
    with a spec for each tensor: batch (dim 0) over the data axes;
    attention KV head dims over the model axis when head-aligned.
    Conservative for state caches (mamba/rwkv): batch sharding only. The
    reference's leaves carry a stacking dim first, so its batch is dim 1
    and its KV leaves have 5 dims where the port's have 4."""
    dp = tuple(a for a in mesh.axes if a in ("pod", "data"))
    dp_deg = _degree(mesh, dp)
    tp = mesh.model_degree
    head_sizes = set()
    if cfg.num_kv_heads:
        head_sizes.add(cfg.num_kv_heads)
        head_sizes.add(pad_heads(cfg.num_kv_heads, tp))
    if cfg.num_heads:
        head_sizes.add(pad_heads(cfg.num_heads, tp))

    def one(leaf) -> Spec:
        nd = len(leaf.shape)
        entries: list = [None] * nd
        if nd >= 1 and leaf.shape[0] == shape.global_batch \
                and dp_deg > 1 and leaf.shape[0] % dp_deg == 0:
            entries[0] = _axes_entry(dp)
        if nd == 4 and tp > 1 and leaf.shape[-2] in head_sizes \
                and leaf.shape[-2] % tp == 0:
            entries[-2] = "model"
        return tuple(entries)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return one(node)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return type(node)(walk(v) for v in node)

    return walk(cache)


# ---------------------------------------------------------------------------
# analytic collective accounting (per-SL communication projection)


def tp_activation_wire_bytes(cfg: ModelConfig, global_batch: int,
                             seq_len: int, tp: int, *,
                             dtype_bytes: int = 2,
                             training: bool = True) -> float:
    """Per-step on-the-wire bytes of the TP activation all-reduces.

    Megatron layout: 2 all-reduces of the (B, S, d) residual per block
    (attention output + FFN output), each ring all-reduce moving
    ``2*(tp-1)/tp`` bytes per buffer byte; backward doubles them. This is
    the SL-proportional communication term SeqPoint projects.
    """
    if tp <= 1:
        return 0.0
    buf = global_batch * seq_len * cfg.d_model * dtype_bytes
    per_block = 2 * buf * 2.0 * (tp - 1) / tp
    total = per_block * cfg.num_layers
    if training:
        total *= 2.0
    return float(total)


def dp_grad_reduce_elems(params, specs: Mapping[str, Spec],
                         mesh: MeshConfig) -> float:
    """Per-device gradient elements participating in the DP reduction.

    The DP gradient reduce spans the data axes, so each device's buffer is
    its leaf shard over the *non-data* mesh axes only: a TP-sharded kernel
    contributes ``size/tp``, a replicated leaf contributes its full size.
    Summed over the port's per-layer tensors it equals the reference's sum
    over stacked leaves.
    """
    extent = dict(zip(mesh.axes, mesh.shape))
    data_axes = {"pod", "data"}
    total = 0.0
    for name, (shape, _) in _shapes(params).items():
        shards = 1
        for entry in specs[name]:
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            for a in names:
                if a not in data_axes:
                    shards *= extent.get(a, 1)
        size = 1
        for dim in shape:
            size *= int(dim)
        total += size / max(shards, 1)
    return float(total)


# ---------------------------------------------------------------------------
# DTensor placement


def distribute_params(model: torch.nn.Module, mesh,
                      specs: Mapping[str, Spec],
                      src_data_rank: Optional[int] = None) -> None:
    """Replace every parameter of ``model`` by a DTensor on ``mesh`` (a
    ``DeviceMesh`` whose dim names are the ``MeshConfig``'s axes) placed by
    its spec. With ``src_data_rank=None`` each rank keeps its own shard of
    the tensor it already holds (every rank loaded the same weights), so no
    data moves."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.axes import placements

    for name, p in list(model.named_parameters()):
        mod = model.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        dt = distribute_tensor(p.detach(), mesh,
                               placements(specs[name], mesh),
                               src_data_rank=src_data_rank)
        setattr(mod, leaf, torch.nn.Parameter(dt,
                                              requires_grad=p.requires_grad))
