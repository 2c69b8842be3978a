"""Mixture-of-experts: top-k router and capacity-bounded dispatch, one
device.

A port of ``repro.models.moe``'s single-device path (the one it runs
without a mesh). Each token's top-k assignments are ranked within their
expert by a stable sort of the token-major flattening (t0 slot0, t0 slot1,
t1 slot0, ...), so the same assignments overflow an expert's capacity as in
the reference; assignments at or past the capacity go to a spill column
and contribute nothing. Every expert's gated FFN runs as one batched
product over the fixed ``(E, cap, d)`` buffer, as XLA runs the reference's
einsum. The capacity counts every token of the (padded) batch.

Under a mesh with a "model" axis (``dist.axes.use_mesh``, DTensor
activations and parameters) ``moe_forward`` takes the reference's
expert-parallel paths, each a ``local_map`` region over explicit
collectives where the reference has a ``shard_map``:
``_moe_forward_sharded`` (experts over "model" when their count divides
its degree, else every expert's FFN width over "model"; the partial
outputs merge in one all-reduce over "model", which the region leaves to
DTensor as a partial-sum placement) and ``_moe_forward_full_ep`` (experts
over data x model, tokens sent to their experts and back through two
fixed-capacity all-to-alls that carry gradients).

Each ``moe_forward`` call is a ``torch.profiler`` range named
``PROFILE_RANGE``, so a trace can sum the device time of the MoE's kernels
(a few microseconds of host time a call when no profiler runs).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import regions
from repro_torch.dist.axes import current_mesh_axes, mesh_extent
from repro_torch.models.layers import act_fn, dense_init

PROFILE_RANGE = "moe_forward"


def expert_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = num_tokens * m.experts_per_token / m.num_experts * m.capacity_factor
    return max(8, int(math.ceil(cap / 8.0)) * 8)


class MoE(nn.Module):
    """Router and expert weights, named as the JAX package's leaves. The
    router stays float32 whatever the parameter type, as in the
    reference."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        f = m.expert_d_ff or cfg.d_ff

        def param(shape, dt=dtype):
            return nn.Parameter(dense_init(shape, generator, dt))

        self.router = param((d, m.num_experts), torch.float32)
        self.e_wg = param((m.num_experts, d, f))
        self.e_wu = param((m.num_experts, d, f))
        self.e_wo = param((m.num_experts, f, d))
        if m.num_shared_experts:
            fs = f * m.num_shared_experts
            self.s_wg = param((d, fs))
            self.s_wu = param((d, fs))
            self.s_wo = param((fs, d))


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, eidx


def _positions(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Rank of each assignment within its expert (sort-based, stable)."""
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    run_start = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=flat_e.device))
    pos_sorted = torch.arange(tk, device=flat_e.device) - run_start[sorted_e]
    return torch.zeros_like(flat_e).scatter_(0, order, pos_sorted)


def _expert_glu(buf: torch.Tensor, e_wg, e_wu, e_wo, act: str
                ) -> torch.Tensor:
    dt = buf.dtype
    g = torch.bmm(buf, e_wg.to(dt))
    u = torch.bmm(buf, e_wu.to(dt))
    return torch.bmm(act_fn(act)(g) * u, e_wo.to(dt))


def _moe_math(xt, router, e_wg, e_wu, e_wo, cfg: ModelConfig, *,
              first_expert=None, num_experts_global: int = 0):
    """Single-shard MoE math over the (local) expert slice [first_expert,
    first_expert + E_loc): xt (T, d) -> (y (T, d) float32, aux).
    ``first_expert=None`` means all experts are local."""
    m = cfg.moe
    t, d = xt.shape
    e_loc = e_wg.shape[0]
    e_glob = num_experts_global or m.num_experts
    k = m.experts_per_token
    probs, gate, eidx = _route(xt, router, k)
    cap = expert_capacity(t, cfg)

    flat_e = eidx.reshape(-1)
    pos = _positions(flat_e, e_glob).reshape(t, k)
    if first_expert is None:
        local_e = eidx
        keep = pos < cap
    else:
        local_e = eidx - first_expert
        keep = (local_e >= 0) & (local_e < e_loc) & (pos < cap)
    dest_e = torch.where(keep, local_e, 0)
    dest_c = torch.where(keep, pos, cap)                   # cap col = spill

    buf = torch.zeros((e_loc, cap + 1, d), dtype=xt.dtype, device=xt.device)
    for slot in range(k):
        buf[dest_e[:, slot], dest_c[:, slot]] = xt
    y_buf = _expert_glu(buf[:, :cap], e_wg, e_wu, e_wo, cfg.act)

    y = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    for slot in range(k):
        contrib = y_buf[dest_e[:, slot], dest_c[:, slot].clamp_max(cap - 1)]
        contrib = torch.where(keep[:, slot, None], contrib.float(), 0.0)
        y = y + contrib * gate[:, slot, None]

    # Switch-style load-balance loss (a local estimate), counts by
    # scatter-add
    me = probs.mean(dim=0)
    counts = torch.zeros(e_glob, dtype=torch.float32, device=xt.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    assign = counts / flat_e.shape[0]
    aux = e_glob * torch.sum(me * assign) * m.router_aux_coef
    return y, aux


def _shared_glu(xt, s_wg, s_wu, s_wo, act: str) -> torch.Tensor:
    dt = xt.dtype
    return (act_fn(act)(xt @ s_wg.to(dt)) * (xt @ s_wu.to(dt))) \
        @ s_wo.to(dt)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                full_ep: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out in x's type, aux loss). Under a mesh with a
    "model" axis the expert-parallel path (``full_ep``: over data x model
    with an all-to-all), the plain path otherwise."""
    b, s, d = x.shape
    with torch.profiler.record_function(PROFILE_RANGE):
        if "model" in current_mesh_axes():
            if full_ep:
                return _moe_forward_full_ep(p, x, cfg)
            return _moe_forward_sharded(p, x, cfg)
        xt = x.reshape(b * s, d)
        y, aux = _moe_math(xt, p.router, p.e_wg, p.e_wu, p.e_wo, cfg)
        if cfg.moe.num_shared_experts:
            y = y + _shared_glu(xt, p.s_wg, p.s_wu, p.s_wo,
                                cfg.act).float()
        return y.to(x.dtype).reshape(b, s, d), aux


def _moe_forward_sharded(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Experts over "model" (EP) when the expert count divides its degree,
    else expert-TP (each rank holds every expert's slice of the FFN
    width); shared experts are FFN-width sharded either way. Each rank
    routes its data shard's tokens, runs its experts (or slices) and
    returns a partial sum over "model"; aux is averaged over the data axes
    (where they split the batch) and "model"."""
    mesh = x.device_mesh
    m = cfg.moe
    b, s, d = x.shape
    dp = regions.batch_axes(mesh, b)
    tp = regions.model_size(mesh)
    ep = m.num_experts % tp == 0
    shared = bool(m.num_shared_experts)
    rank = regions.model_rank(mesh)
    place = regions.place
    x_spec = (regions.entry(dp), None, None)
    if ep:
        ew = [place(mesh, ("model", None, None))] * 3
    else:
        ew = [place(mesh, (None, None, "model")),
              place(mesh, (None, None, "model")),
              place(mesh, (None, "model", None))]
    sw = [place(mesh, (None, "model")), place(mesh, (None, "model")),
          place(mesh, ("model", None))] if shared else []

    n_avg = mesh_extent(mesh, dp + ("model",))

    def local(x, router, e_wg, e_wu, e_wo, *shared_w):
        bl, sl, _ = x.shape
        xt = x.reshape(bl * sl, d)
        first = rank * (m.num_experts // tp) if ep else None
        y, aux = _moe_math(xt, router, e_wg, e_wu, e_wo, cfg,
                           first_expert=first,
                           num_experts_global=m.num_experts)
        if shared:
            y = y + _shared_glu(xt, *shared_w, cfg.act).float()
        return y.to(x.dtype).reshape(bl, sl, d), aux / n_avg

    # y: one all-reduce over "model"; aux: the mean over the data axes
    # that split the batch and over "model", as a sum of shares
    outs = (place(mesh, x_spec, partial=("model",)),
            place(mesh, (), partial=dp + ("model",)))
    args = [x, p.router, p.e_wg, p.e_wu, p.e_wo]
    if shared:
        args += [p.s_wg, p.s_wu, p.s_wo]
    return regions.run_local(local, mesh,
                             [place(mesh, x_spec), place(mesh, ())] + ew + sw,
                             outs, *args)


def _moe_forward_full_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Full expert parallelism over (data x model): each rank owns E /
    n_dev experts, and tokens move to their experts through a
    fixed-capacity all-to-all (capacity per source/destination pair, no
    8-row floor), run as a batched GLU there and come back through a
    second all-to-all, both ``all_to_all_single_autograd`` so gradients
    flow through them. Training and prefill split each data shard's
    tokens over "model" along the sequence; decode (S < the model degree)
    replicates them over "model", partitions the assignments by routing
    slot across model ranks and sums the outputs over "model". Shared
    experts run outside the region on DTensors, as the reference leaves
    them to the partitioner."""
    import torch.distributed._functional_collectives as funcol

    mesh = x.device_mesh
    m = cfg.moe
    b, s, d = x.shape
    names = tuple(mesh.mesh_dim_names)
    ep_axes = tuple(a for a in names if a in ("data", "model"))
    n_dev = mesh_extent(mesh, ep_axes)
    assert m.num_experts % n_dev == 0, (m.num_experts, n_dev)
    e_loc = m.num_experts // n_dev
    dp = tuple(a for a in names if a in ("pod", "data"))
    assert b % mesh_extent(mesh, dp) == 0
    tp_size = regions.model_size(mesh)
    rank = regions.model_rank(mesh)
    seq_split = s % tp_size == 0 and s >= tp_size
    n_avg = mesh_extent(mesh, dp + ("model",))
    group = mesh[ep_axes]._flatten() if len(ep_axes) > 1 \
        else mesh[ep_axes[0]]
    k = m.experts_per_token

    def local(x, router, e_wg, e_wu, e_wo):
        bl, sl, _ = x.shape
        t = bl * sl
        xt = x.reshape(t, d)
        probs, gate, eidx = _route(xt, router, k)
        raw = t * k / n_dev * m.capacity_factor
        cap = int(-(-raw // 8)) * 8 if raw > 8 else max(1, int(-(-raw // 1)))
        flat_e = eidx.reshape(-1)
        dest_dev = flat_e // e_loc
        dest_slot = flat_e % e_loc
        pos = _positions(dest_dev, n_dev).reshape(t, k)
        keep = pos < cap
        if not seq_split:
            mine = (torch.arange(t * k, device=x.device) % tp_size) == rank
            keep = keep & mine.reshape(t, k)
        dd = torch.where(keep, dest_dev.reshape(t, k), 0)
        dc = torch.where(keep, pos, cap)
        send = torch.zeros((n_dev, cap + 1, d), dtype=x.dtype,
                           device=x.device)
        send_e = torch.zeros((n_dev, cap + 1), dtype=torch.long,
                             device=x.device)
        slots = dest_slot.reshape(t, k)
        for slot in range(k):
            send[dd[:, slot], dc[:, slot]] = xt
            send_e[dd[:, slot], dc[:, slot]] = slots[:, slot]
        send, send_e = send[:, :cap], send_e[:, :cap]
        recv = funcol.all_to_all_single_autograd(
            send.reshape(n_dev * cap, d), None, None, group)
        recv_e = funcol.all_to_all_single(
            send_e.reshape(n_dev * cap).contiguous(), None, None, group)
        rt = funcol.wait_tensor(recv)
        re = funcol.wait_tensor(recv_e)
        # dispatch received tokens into the local experts' buffers
        cap2 = n_dev * cap          # worst case: all land on one expert
        pos2 = _positions(re, e_loc)
        buf = torch.zeros((e_loc, cap2, d), dtype=x.dtype, device=x.device)
        buf[re, pos2] = rt
        y_tok = _expert_glu(buf, e_wg, e_wu, e_wo, cfg.act)[re, pos2]
        back = funcol.wait_tensor(funcol.all_to_all_single_autograd(
            y_tok.contiguous(), None, None, group)).reshape(n_dev, cap, d)
        y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
        for slot in range(k):
            contrib = back[dd[:, slot], dc[:, slot].clamp_max(cap - 1)]
            contrib = torch.where(keep[:, slot, None], contrib.float(), 0.0)
            y = y + contrib * gate[:, slot, None]
        me = probs.mean(dim=0)
        counts = torch.zeros(m.num_experts, dtype=torch.float32,
                             device=x.device)
        counts.index_add_(0, flat_e,
                          torch.ones_like(flat_e, dtype=torch.float32))
        aux = m.num_experts * torch.sum(me * counts / flat_e.shape[0]) \
            * m.router_aux_coef
        return y.to(x.dtype).reshape(bl, sl, d), aux / n_avg

    place = regions.place
    x_spec = (regions.entry(dp), "model" if seq_split else None, None)
    ew = place(mesh, (ep_axes, None, None))
    outs = (place(mesh, x_spec, partial=() if seq_split else ("model",)),
            place(mesh, (), partial=dp + ("model",)))
    y, aux = regions.run_local(local, mesh,
                               [place(mesh, x_spec), place(mesh, ()),
                                ew, ew, ew], outs,
                               x, p.router, p.e_wg, p.e_wu, p.e_wo)
    if m.num_shared_experts:
        xt = x.reshape(b * s, d)
        y = y + _shared_glu(xt, p.s_wg, p.s_wu, p.s_wo,
                            cfg.act).to(y.dtype).reshape(b, s, d)
    return y, aux
