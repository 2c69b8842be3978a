"""Mixture-of-experts: top-k router and capacity-bounded dispatch, one
device.

A port of ``repro.models.moe``'s single-device path (the one it runs
without a mesh). Each token's top-k assignments are ranked within their
expert by a stable sort of the token-major flattening (t0 slot0, t0 slot1,
t1 slot0, ...), so the same assignments overflow an expert's capacity as in
the reference; assignments at or past the capacity go to a spill column
and contribute nothing. Every expert's gated FFN runs as one batched
product over the fixed ``(E, cap, d)`` buffer, as XLA runs the reference's
einsum. The capacity counts every token of the (padded) batch. The
expert-parallel paths (``_moe_forward_sharded``, ``_moe_forward_full_ep``)
come with the distribution slice.

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


def _moe_math(xt, router, e_wg, e_wu, e_wo, cfg: ModelConfig):
    """All experts local: xt (T, d) -> (y (T, d) float32, aux)."""
    m = cfg.moe
    t, d = xt.shape
    e = e_wg.shape[0]
    k = m.experts_per_token
    probs, gate, eidx = _route(xt, router, k)
    cap = expert_capacity(t, cfg)

    flat_e = eidx.reshape(-1)
    pos = _positions(flat_e, e).reshape(t, k)
    keep = pos < cap
    dest_e = torch.where(keep, eidx, 0)
    dest_c = torch.where(keep, pos, cap)                   # cap col = spill

    buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=xt.device)
    for slot in range(k):
        buf[dest_e[:, slot], dest_c[:, slot]] = xt
    y_buf = _expert_glu(buf[:, :cap], e_wg, e_wu, e_wo, cfg.act)

    y = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    for slot in range(k):
        contrib = y_buf[dest_e[:, slot], dest_c[:, slot].clamp_max(cap - 1)]
        contrib = torch.where(keep[:, slot, None], contrib.float(), 0.0)
        y = y + contrib * gate[:, slot, None]

    # Switch-style load-balance loss, counts by scatter-add
    me = probs.mean(dim=0)
    counts = torch.zeros(e, dtype=torch.float32, device=xt.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    assign = counts / flat_e.shape[0]
    aux = e * torch.sum(me * assign) * m.router_aux_coef
    return y, aux


def _shared_glu(xt, s_wg, s_wu, s_wo, act: str) -> torch.Tensor:
    dt = xt.dtype
    return (act_fn(act)(xt @ s_wg.to(dt)) * (xt @ s_wu.to(dt))) \
        @ s_wo.to(dt)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out in x's type, aux loss)."""
    b, s, d = x.shape
    with torch.profiler.record_function(PROFILE_RANGE):
        xt = x.reshape(b * s, d)
        y, aux = _moe_math(xt, p.router, p.e_wg, p.e_wu, p.e_wo, cfg)
        if cfg.moe.num_shared_experts:
            y = y + _shared_glu(xt, p.s_wg, p.s_wu, p.s_wo,
                                cfg.act).float()
        return y.to(x.dtype).reshape(b, s, d), aux
