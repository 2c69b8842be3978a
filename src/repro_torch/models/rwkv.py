"""RWKV-6 (Finch): time-mix with data-dependent decay + channel-mix.

A port of ``repro.models.rwkv``. The WKV recurrence has three forms here:
``wkv6_sequential`` (the oracle, one step at a time), ``wkv6_chunked``
(the reference's chunked linear-attention form; the chunks' states are
carried by a loop where the reference composes them with an
``associative_scan``) and, on a CUDA card, the hand-written Hopper kernel
behind ``repro_torch.kernels.rwkv6_wkv.ops.wkv6``, which every prefill and
decode step there runs. On the CPU, and with ``use_kernel=False``, the
reference's dispatch holds: chunked iff the length is a multiple of the
chunk and longer than it, else sequential.

Numerics, as in the reference: the per-step log-decay is clamped to
[-1, -1e-6], and the serving cache keeps the state in the compute type, so
in bf16 the fp32 state is rounded to bf16 after the prefill and after
every decode step. A model built for tensor parallelism pads the head
count to a multiple of its degree (``_dims``). A decode step updates its
cache's shift and state in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import regions
from repro_torch.kernels.rwkv6_wkv.ops import wkv6
from repro_torch.models.layers import dense_init

W_LORA_DIM = 64
CHUNK = 64

Cache = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig, tp: int = 1) -> Tuple[int, int]:
    """Head count padded to the tensor-parallel degree (rwkv6-3b has 40
    heads; under 16-way tensor parallelism it has 48, so shards hold whole
    heads)."""
    dh = cfg.rwkv_head_dim
    heads = cfg.d_model // dh
    if tp > 1 and heads % tp:
        heads = ((heads + tp - 1) // tp) * tp
    return heads, dh


def _full(shape, value: float, dtype: torch.dtype,
          device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


class TimeMix(nn.Module):
    """Time-mix weights, named as the JAX package's leaves."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype, tp: int = 1):
        super().__init__()
        d = cfg.d_model
        h, dh = _dims(cfg, tp)
        da = h * dh
        dev = generator.device

        def param(shape, scale=None):
            return nn.Parameter(dense_init(shape, generator, dtype, scale))

        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, _full((d,), 0.5, dtype, dev))
        self.w_r = param((d, da))
        self.w_k = param((d, da))
        self.w_v = param((d, da))
        self.w_g = param((d, da))
        self.w_o = param((da, d))
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A1) A2))
        self.w0 = _full((da,), -2.0, dtype, dev)
        self.w_a1 = param((d, W_LORA_DIM))
        self.w_a2 = param((W_LORA_DIM, da), scale=0.1)
        self.u = param((da,), scale=0.5)              # per-channel bonus
        self.ln_w = _full((h, dh), 1.0, dtype, dev)   # per-head groupnorm
        self.ln_b = _full((h, dh), 0.0, dtype, dev)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dev = generator.device
        self.mu_k = _full((d,), 0.5, dtype, dev)
        self.mu_r = _full((d,), 0.5, dtype, dev)
        self.w_k = nn.Parameter(dense_init((d, f), generator, dtype))
        self.w_v = nn.Parameter(dense_init((f, d), generator, dtype))
        self.w_r = nn.Parameter(dense_init((d, d), generator, dtype))


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along seq; ``last`` is the carried token for decode."""
    if last is not None:
        return last[:, None].to(x.dtype)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _log_decay(p: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    f32 = torch.float32
    ww = p.w0.to(f32) + torch.tanh(xw.to(f32) @ p.w_a1.to(f32)) \
        @ p.w_a2.to(f32)
    return torch.clamp(-torch.exp(ww), -1.0, -1e-6)   # log w per channel


def wkv6_sequential(r, k, v, lw, u, state):
    """Oracle recurrence. r,k,v,lw: (B,S,H,dh) fp32; u: (H,dh); state:
    (B,H,dh,dh). Returns (y, final_state)."""
    w = torch.exp(lw)
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        # y = r . (S + diag(u) k v^T)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, state)
                  + (rt * u[None] * kt).sum(-1, keepdim=True) * vt)
        state = wt[..., :, None] * state + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=1), state


def wkv6_chunked(r, k, v, lw, u, state0, chunk: int = CHUNK):
    """Chunked-parallel wkv. Shapes (B,S,H,dh) fp32, state0 (B,H,dh,dh)."""
    b, s, h, dh = r.shape
    assert s % chunk == 0, (s, chunk)
    n = s // chunk
    rc, kc, vc, lwc = (t.reshape(b, n, chunk, h, dh) for t in (r, k, v, lw))
    cs = torch.cumsum(lwc, dim=2)                          # inclusive cumsum
    total = cs[:, :, -1]                                   # (B,n,H,dh)
    # within-chunk pair decays: exp(cs_{i-1} - cs_j), j < i  (<= 1, safe)
    rq = rc * torch.exp(cs - lwc)                          # r * exp(cs_{i-1})
    kk = kc * torch.exp(-cs)                               # k * exp(-cs_j)
    att = torch.einsum("bnihk,bnjhk->bnhij", rq, kk)       # (B,n,H,C,C)
    idx = torch.arange(chunk, device=r.device)
    mask = (idx[:, None] > idx[None, :]).to(att.dtype)
    diag = torch.einsum("bnihk,bnihk->bnih", rc, u.reshape(1, 1, 1, h, dh) * kc)
    y_intra = torch.einsum("bnhij,bnjhv->bnihv", att * mask, vc) \
        + diag[..., None] * vc

    # inter-chunk: U_c = sum_j (k_j * exp(total - cs_j)) v_j^T
    kdec = kc * torch.exp(total[:, :, None] - cs)
    u_c = torch.einsum("bnjhk,bnjhv->bnhkv", kdec, vc)     # (B,n,H,dh,dh)
    d_c = torch.exp(total)                                 # (B,n,H,dh)
    state, ys = state0, []
    for c in range(n):                                     # state entering c
        ys.append(y_intra[:, c]
                  + torch.einsum("bihk,bhkv->bihv", rq[:, c], state))
        state = state * d_c[:, c, ..., None] + u_c[:, c]
    return torch.stack(ys, dim=1).reshape(b, s, h, dh), state


def _wkv(r, k, v, lw, u, state0, chunk: int, use_kernel: bool):
    if use_kernel and r.is_cuda:
        return wkv6(r, k, v, lw, u, state0)
    s = r.shape[1]
    if state0 is None:
        b, _, h, dh = r.shape
        state0 = torch.zeros((b, h, dh, dh), dtype=r.dtype, device=r.device)
    if s % chunk == 0 and s > chunk:
        return wkv6_chunked(r, k, v, lw, u, state0, chunk)
    return wkv6_sequential(r, k, v, lw, u, state0)


def _wkv_region(r, k, v, lw, u, chunk: int, use_kernel: bool):
    """The WKV recurrence on each rank's heads (batch over the data axes,
    heads over "model" when its degree divides them): the kernel never
    sees a DTensor, and the chunked form's ``cumsum`` has no sharding
    rule."""
    mesh, dp, hd = regions.split_entries(r, 2)
    x_pl = regions.place(mesh, (dp, None, hd, None))

    def local(r, k, v, lw, u):
        return _wkv(r, k, v, lw, u, None, chunk, use_kernel)

    return regions.run_local(
        local, mesh, [x_pl] * 4 + [regions.place(mesh, (hd, None))],
        (x_pl, regions.place(mesh, (dp, hd, None, None))), r, k, v, lw, u)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def time_mix_forward(p: TimeMix, x: torch.Tensor, cfg: ModelConfig, *,
                     cache: Optional[Cache] = None,
                     return_state: bool = False, chunk: int = CHUNK,
                     use_kernel: bool = True):
    """With ``cache`` ({"shift", "state"}) it runs one decode step and
    writes the new shift and state into the cache in place."""
    dh = cfg.rwkv_head_dim
    h = p.ln_w.shape[0]
    b, s, _ = x.shape
    last = cache["shift"] if cache is not None else None
    xx = _shift(x, last) - x

    def mix(mu):
        return x + xx * mu.to(x.dtype)

    f32 = torch.float32
    r = _proj(mix(p.mu_r), p.w_r).to(f32).reshape(b, s, h, dh)
    k = _proj(mix(p.mu_k), p.w_k).to(f32).reshape(b, s, h, dh)
    v = _proj(mix(p.mu_v), p.w_v).to(f32).reshape(b, s, h, dh)
    g = F.silu(_proj(mix(p.mu_g), p.w_g))
    lw = _log_decay(p, mix(p.mu_w)).reshape(b, s, h, dh)
    u = p.u.to(f32).reshape(h, dh)

    new_cache = None
    if cache is not None:
        assert s == 1, "cache path is a single decode step"
        y, s_new = _wkv(r, k, v, lw, u, cache["state"].to(f32), chunk,
                        use_kernel)
        cache["shift"].copy_(x[:, -1])
        cache["state"].copy_(s_new)
        new_cache = cache
    else:
        if regions.is_dtensor(r):
            y, s_fin = _wkv_region(r, k, v, lw, u, chunk, use_kernel)
        else:
            y, s_fin = _wkv(r, k, v, lw, u, None, chunk, use_kernel)
        if return_state:
            new_cache = {"shift": x[:, -1], "state": s_fin.to(x.dtype)}

    # per-head groupnorm, gate, out-proj
    var, mu = torch.var_mean(y, dim=-1, keepdim=True, unbiased=False)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    yn = yn * p.ln_w.to(f32) + p.ln_b.to(f32)
    out = yn.reshape(b, s, h * dh).to(x.dtype) * g
    return _proj(out, p.w_o), new_cache


def channel_mix_forward(p: ChannelMix, x: torch.Tensor, cfg: ModelConfig, *,
                        cache: Optional[Cache] = None,
                        return_state: bool = False):
    """With ``cache`` ({"shift"}) the new shift is written in place."""
    last = cache["shift"] if cache is not None else None
    xx = _shift(x, last) - x
    xk = x + xx * p.mu_k.to(x.dtype)
    xr = x + xx * p.mu_r.to(x.dtype)
    kk = torch.square(F.relu(_proj(xk, p.w_k)))
    kv = _proj(kk, p.w_v)
    out = torch.sigmoid(_proj(xr, p.w_r)) * kv
    new_cache = None
    if cache is not None:
        cache["shift"].copy_(x[:, -1])
        new_cache = cache
    elif return_state:
        new_cache = {"shift": x[:, -1]}
    return out, new_cache


def init_time_mix_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                        device: torch.device, tp: int = 1) -> Cache:
    h, dh = _dims(cfg, tp)
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
            "state": torch.zeros((batch, h, dh, dh), dtype=dtype,
                                 device=device)}


def init_channel_mix_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                           device: torch.device) -> Cache:
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device)}
