"""Attention: GQA/MHA with memory-sane chunked softmax, MLA, decode paths.

Copies ``repro.models.attention``. The chunked path is the plain analogue
of the flash kernel (online softmax over KV chunks, so S^2 score matrices
are never materialized). On a CUDA card, attention without a cache and
without ``kv_valid_len`` (every prefill, whisper's encoder and its
cross-attention, MLA's expanded prefill at head_dim 192) runs the
hand-written flash kernel at every length
(``repro_torch.kernels.flash_attention``); elsewhere, and with
``use_kernel=False``, ``attention_core`` dispatches as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import regions
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B, S, Hkv, dh) -> (B, S, Hq, dh) by repeating each group."""
    hkv = k.shape[2]
    if hkv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // hkv, dim=2)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool,
                   kv_valid_len: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Reference O(S^2)-memory attention. q:(B,Sq,H,dh) k/v:(B,Skv,H,dh)."""
    sq, dh = q.shape[1], q.shape[3]
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kpos = torch.arange(skv, device=q.device)
    if kv_valid_len is not None:
        vmask = kpos[None, :] < kv_valid_len[:, None]     # (B, Skv)
        scores = scores.masked_fill(~vmask[:, None, None, :], NEG_INF)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]             # (Sq, Skv)
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int) -> torch.Tensor:
    """Online-softmax attention looping over KV chunks (flash-style)."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    assert skv % chunk == 0, (skv, chunk)
    scale = 1.0 / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=v.dtype, device=q.device)
    for j in range(skv // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kj.float()) * scale
        if causal:
            kpos = j * chunk + torch.arange(chunk, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            s = s.masked_fill(~mask[None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vj.dtype), vj)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
    return out.transpose(1, 2)                            # (B, Sq, H, dh)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid_len: torch.Tensor) -> torch.Tensor:
    """Single-step decode without expanding KV to query heads.
    q: (B, 1, Hq, dh); k/v: (B, S, Hkv, dh)."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    q5 = q.reshape(b, sq, hkv, hq // hkv, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    vmask = (kpos[None, :] < kv_valid_len[:, None])[:, None, None, None, :]
    scores = scores.masked_fill(~vmask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, dh)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, chunk: int = 0,
                   kv_valid_len: Optional[torch.Tensor] = None,
                   use_kernel: bool = True) -> torch.Tensor:
    """Dispatch between the flash kernel, full and chunked paths. The
    kernel reads grouped KV heads in place; the plain paths repeat them.
    DTensors (a sharded forward) go through ``_attention_region``."""
    if regions.is_dtensor(q):
        if kv_valid_len is None:
            return _attention_region(q, k, v, causal=causal, chunk=chunk,
                                     use_kernel=use_kernel)
        return _decode_region(q, k, v, kv_valid_len)
    if use_kernel and q.is_cuda and kv_valid_len is None:
        return flash_attention(q, k, v, causal)
    if kv_valid_len is not None and q.shape[1] == 1 and not causal \
            and q.shape[2] % k.shape[2] == 0:
        return gqa_decode_attention(q, k, v, kv_valid_len)
    k = _repeat_kv(k, q.shape[2])
    v = _repeat_kv(v, q.shape[2])
    skv = k.shape[1]
    if chunk and skv % chunk == 0 and skv > chunk and kv_valid_len is None:
        return chunked_attention(q, k, v, causal=causal, chunk=chunk)
    return full_attention(q, k, v, causal=causal, kv_valid_len=kv_valid_len)


def _attention_region(q, k, v, *, causal: bool, chunk: int,
                      use_kernel: bool) -> torch.Tensor:
    """``attention_core`` on each rank's shard: batch over the data axes,
    query heads over "model" when its degree divides them. Key/value heads
    are sharded with them when the degree divides the KV heads too;
    otherwise every rank holds all KV heads and takes, repeated to query
    heads, the ones its own query heads read."""
    mesh, dp, heads = regions.split_entries(q, 2)
    hq = q.shape[2]
    tp = regions.model_size(mesh)
    kv_heads = heads if heads and k.shape[2] % tp == 0 else None
    rank = regions.model_rank(mesh)

    def local(q, k, v):
        if heads and not kv_heads:
            hl = q.shape[2]
            k, v = (_repeat_kv(t, hq)[:, :, rank * hl:(rank + 1) * hl]
                    for t in (k, v))
        return attention_core(q, k, v, causal=causal, chunk=chunk,
                              use_kernel=use_kernel)

    qs = regions.place(mesh, (dp, None, heads, None))
    ks = regions.place(mesh, (dp, None, kv_heads, None))
    return regions.run_local(local, mesh, (qs, ks, ks), qs, q, k, v)


def _decode_region(q, k, v, kv_valid_len: torch.Tensor) -> torch.Tensor:
    """Cached decode attention on each rank's shard (a grouped query's
    reshape has no sharding rule when the model degree splits a group):
    batch over the data axes, query heads over "model" when its degree
    divides them, the cache's KV heads with them when it divides those
    too. Otherwise every rank holds all KV heads and reads only the ones
    its own query heads use, one a head. ``kv_valid_len`` is the same
    length for every row (the step's ``cache_index + 1``), so each rank
    takes its first rows."""
    mesh, dp, heads = regions.split_entries(q, 2)
    hq, hkv = q.shape[2], k.shape[2]
    tp = regions.model_size(mesh)
    kv_heads = heads if heads and hkv % tp == 0 else None
    rank = regions.model_rank(mesh)

    def local(q, k, v):
        if heads and not kv_heads:
            hl = q.shape[2]
            idx = torch.arange(rank * hl, (rank + 1) * hl,
                               device=q.device) // (hq // hkv)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return gqa_decode_attention(q, k, v, kv_valid_len[:q.shape[0]])

    qs = regions.place(mesh, (dp, None, heads, None))
    ks = regions.place(mesh, (dp, None, kv_heads, None))
    return regions.run_local(local, mesh, (qs, ks, ks), qs, q, k, v)


# ---------------------------------------------------------------------------
# GQA block


class GQA(nn.Module):
    """Grouped-query self-attention weights: wq (d, Hq*dh), wk/wv
    (d, Hkv*dh), wo (Hq*dh, d), and the q/k/v biases where configured."""

    def __init__(self, cfg: ModelConfig, num_q_heads: int,
                 generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = num_q_heads, cfg.num_kv_heads

        def param(shape):
            return nn.Parameter(dense_init(shape, generator, dtype))

        self.wq = param((d, hq * dh))
        self.wk = param((d, hkv * dh))
        self.wv = param((d, hkv * dh))
        self.wo = param((hq * dh, d))
        if cfg.qkv_bias:
            dev = generator.device
            self.bq = nn.Parameter(torch.zeros(hq * dh, dtype=dtype,
                                               device=dev))
            self.bk = nn.Parameter(torch.zeros(hkv * dh, dtype=dtype,
                                               device=dev))
            self.bv = nn.Parameter(torch.zeros(hkv * dh, dtype=dtype,
                                               device=dev))


def init_gqa(cfg: ModelConfig, num_q_heads: int, generator: torch.Generator,
             dtype: torch.dtype) -> GQA:
    return GQA(cfg, num_q_heads, generator, dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _kv_group(x: torch.Tensor, p: GQA, hq: int, hkv: int, dh: int) -> int:
    """The number g of model ranks that share a KV head in a sharded
    forward whose query heads "model" splits but whose KV heads it cannot
    (fewer KV heads than ranks: ``wk`` and ``wv`` are whole on every rank,
    the reference's spec), or 0 where K and V are projected as DTensors.
    With g, each rank projects only its 1/g of the columns of the one KV
    head its query heads read, and the g ranks of the head exchange them
    (``_kv_group_region``)."""
    if not regions.is_dtensor(x):
        return 0
    mesh = x.device_mesh
    tp = regions.model_size(mesh)
    if tp <= 1 or hkv >= tp or tp % hkv or hq % tp or hq % hkv \
            or dh % (tp // hkv):
        return 0
    m = tuple(mesh.mesh_dim_names).index("model")
    whole = x.placements[m].is_replicate() \
        and p.wk.placements[m].is_replicate()
    return tp // hkv if whole and p.wq.placements[m].is_shard(1) else 0


def _kv_group_region(x: torch.Tensor, p: GQA, g: int, dh: int):
    """K and V (B, S, tp, dh) of a sharded forward whose ``tp`` model ranks
    share each KV head g at a time: rank r holds head r // g, the one its
    query heads read (head h repeated g times, sharded over "model"). Rank
    r projects columns [r c, (r + 1) c) of ``wk`` and ``wv`` (c = dh / g,
    a tp-th of the K and V products) and one all-to-all over "model" sends
    them to the g ranks of its head, which concatenate the g slices in
    rank order; the backward sums each slice's g gradients. The weights'
    gradients are partial sums over "model", as the whole projections'
    are."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd, wait_tensor)

    mesh = x.device_mesh
    tp, rank = regions.model_size(mesh), regions.model_rank(mesh)
    group = mesh["model"]
    c = dh // g
    cols = slice(rank * c, (rank + 1) * c)
    first = rank - rank % g
    members = [1 if first <= d < first + g else 0 for d in range(tp)]

    def one(x, w, b):
        t = x @ w[:, cols].to(x.dtype)
        if b is not None:
            t = t + b[cols].to(t.dtype)
        recv = wait_tensor(all_to_all_single_autograd(
            torch.stack([t] * g), members, members, group))
        return recv.permute(1, 2, 0, 3).reshape(t.shape[0], t.shape[1],
                                                1, dh)

    def local(x, wk, wv, bk, bv):
        return one(x, wk, bk), one(x, wv, bv)

    place = regions.place
    dp = regions.entry(regions.batch_axes(mesh, x.shape[0]))
    bk, bv = getattr(p, "bk", None), getattr(p, "bv", None)
    b_pl = None if bk is None else place(mesh, (None,))
    w_pl = place(mesh, (None, None))
    out = place(mesh, (dp, None, "model", None))
    return regions.run_local(
        local, mesh, [place(mesh, (dp, None, None)), w_pl, w_pl, b_pl, b_pl],
        (out, out), x, p.wk, p.wv, bk, bv, split=("model",))


def cache_step(cache: Tuple[torch.Tensor, torch.Tensor],
               new: Tuple[torch.Tensor, torch.Tensor], cache_index: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step's pair (each (B, 1, ...)) into a cache pair
    (each (B, S, ...)) in place at ``cache_index`` and return each leaf's
    first ``cache_index + 1`` positions, the ones the step attends: the
    positions after it would get exactly zero weight. As the reference's
    dynamic_update_slice, a write past the end lands on the last slot."""
    slot = min(cache_index, cache[0].shape[1] - 1)
    for c, x in zip(cache, new):
        c[:, slot] = x[:, 0].to(c.dtype)
    n = min(cache_index + 1, cache[0].shape[1])
    return cache[0][:, :n], cache[1][:, :n]


def gqa_forward(p: GQA, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, causal: bool = True, chunk: int = 0,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                return_kv: bool = False, use_kernel: bool = True):
    """Self-attention. With ``cache=(K, V)`` and ``cache_index`` it runs one
    decode step: K and V of the new token are written into the cache in
    place (the JAX reference returns updated copies; the engine there
    donates the old ones), and the step attends ``cache_index + 1`` keys.
    Under a mesh with more "model" ranks than KV heads, a forward that
    keeps no cache (training) projects K and V a tp-th a rank and
    exchanges them within each head's ranks (``_kv_group_region``)."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    hq = p.wq.shape[1] // dh
    hkv = p.wk.shape[1] // dh
    q = _proj(x, p.wq)
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
    # a cache (decode, or a prefill that returns one) holds every KV head
    g = 0 if cache is not None or return_kv else _kv_group(x, p, hq, hkv, dh)
    if g:
        k, v = _kv_group_region(x, p, g, dh)
        hkv = k.shape[2]
    else:
        k, v = _proj(x, p.wk), _proj(x, p.wv)
        if cfg.qkv_bias:
            k = k + p.bk.to(k.dtype)
            v = v + p.bv.to(v.dtype)
    q = regions.whole_heads(q, hq)
    k, v = (regions.whole_heads(t, hkv) for t in (k, v))
    q = apply_rope(q.reshape(b, s, hq, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hkv, dh), positions, cfg.rope_theta)
    v = v.reshape(b, s, hkv, dh)

    new_cache = None
    if cache is not None:
        assert s == 1, "cache path is a single decode step"
        ck, cv = cache_step(cache, (k, v), cache_index)
        new_cache = cache
        valid = torch.full((b,), ck.shape[1], dtype=torch.long,
                           device=x.device)
        out = attention_core(q, ck, cv, causal=False, kv_valid_len=valid)
    else:
        out = attention_core(q, k, v, causal=causal, chunk=chunk,
                             use_kernel=use_kernel)
        if return_kv:
            new_cache = (k, v)
    y = _proj(out.reshape(b, s, hq * dh), p.wo)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)


class MLA(nn.Module):
    """Multi-head latent attention weights, named as the JAX package's
    leaves: the query's low-rank path (``w_dq``, ``q_norm``, ``w_uq``), the
    shared KV latent (``w_dkv``, ``kv_norm``) and rope key (``w_kr``), the
    latent's up-projections (``w_uk``, ``w_uv``) and ``wo``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        qk = m.qk_nope_head_dim

        def param(shape):
            return nn.Parameter(dense_init(shape, generator, dtype))

        def ones(n):
            return nn.Parameter(torch.ones(n, dtype=dtype,
                                           device=generator.device))

        self.w_dq = param((d, m.q_lora_rank))
        self.q_norm = ones(m.q_lora_rank)
        self.w_uq = param((m.q_lora_rank, h * (qk + m.qk_rope_head_dim)))
        self.w_dkv = param((d, m.kv_lora_rank))
        self.kv_norm = ones(m.kv_lora_rank)
        self.w_kr = param((d, m.qk_rope_head_dim))
        self.w_uk = param((m.kv_lora_rank, h * qk))
        self.w_uv = param((m.kv_lora_rank, h * m.v_head_dim))
        self.wo = param((h * m.v_head_dim, d))


def init_mla(cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype) -> MLA:
    return MLA(cfg, generator, dtype)


def _mla_q(p: MLA, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor):
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    cq = rms_norm(_proj(x, p.w_dq), p.q_norm, cfg.norm_eps)
    q = _proj(cq, p.w_uq).reshape(b, s, h, m.qk_head_dim)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    ckv = rms_norm(_proj(x, p.w_dkv), p.kv_norm, cfg.norm_eps)
    kr = _proj(x, p.w_kr)                                 # shared rope key
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def mla_forward(p: MLA, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, chunk: int = 0,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                return_kv: bool = False, use_kernel: bool = True):
    """MLA. The cache holds the compressed latents ``(c_kv (B, S,
    kv_lora_rank), k_rope (B, S, qk_rope_head_dim))``; decode writes the
    new token's into it in place and takes the absorbed form (q^T W_uk
    c_kv) in plain ops over the first ``cache_index + 1`` positions. The
    prefill takes the expanded form: q and k are qk_nope + qk_rope wide and
    v is padded to that width and cut after, as the reference does, so it
    goes through ``attention_core`` (the flash kernel on a card)."""
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, kr = _mla_latent(p, x, cfg, positions)

    if cache is not None:
        assert s == 1, "cache path is a single decode step"
        c, r = cache_step(cache, (ckv, kr), cache_index)
        # absorb W_uk into q: (B,1,H,nope) x (r, H*nope) -> (B,1,H,r)
        w_uk = p.w_uk.to(x.dtype).reshape(m.kv_lora_rank, h,
                                          m.qk_nope_head_dim)
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
        scores = (torch.einsum("bshr,btr->bhst", q_abs.float(), c.float())
                  + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                 r.float()))
        scale = 1.0 / math.sqrt(m.qk_head_dim)
        probs = torch.softmax(scores * scale, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", probs.to(c.dtype), c)
        w_uv = p.w_uv.to(ctx.dtype).reshape(m.kv_lora_rank, h,
                                            m.v_head_dim)
        o = torch.einsum("bshr,rhv->bshv", ctx, w_uv)
        y = _proj(o.reshape(b, s, h * m.v_head_dim), p.wo)
        return y, cache

    # train / prefill: expanded form
    k_nope = _proj(ckv, p.w_uk).reshape(b, s, h, m.qk_nope_head_dim)
    v = _proj(ckv, p.w_uv).reshape(b, s, h, m.v_head_dim)
    k_rope = kr[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    # pad v up to the qk head dim so the shared attention core applies
    pad = m.qk_head_dim - m.v_head_dim
    vpad = torch.cat([v, torch.zeros_like(v[..., :1]).expand(
        *v.shape[:-1], pad)], dim=-1) if pad else v
    out = attention_core(q, k, vpad, causal=True, chunk=chunk,
                         use_kernel=use_kernel)[..., :m.v_head_dim]
    y = _proj(out.reshape(b, s, h * m.v_head_dim), p.wo)
    return y, ((ckv, kr) if return_kv else None)


__all__ = ["GQA", "MLA", "attention_core", "cache_step", "chunked_attention",
           "full_attention", "gqa_decode_attention", "gqa_forward",
           "init_gqa", "init_mla", "mla_forward"]
