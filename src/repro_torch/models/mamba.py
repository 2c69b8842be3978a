"""Mamba-1 selective SSM block (jamba's mixer).

A port of ``repro.models.mamba``. The reference scans a materialized
``(B, S, d_inner, d_state)`` tensor with ``jax.lax.associative_scan``; at
jamba's width that is over a gigabyte per tensor, so the port never forms
it: ``_ssm_inputs`` returns delta, A, B and C, and the selective scan
(``repro_torch.kernels.mamba_scan.ops.mamba_scan``) forms dA and dBx step
by step. On a CUDA card every prefill (state out) and every decode step
(state in and out) runs the hand-written Hopper kernel; on the CPU, and with
``use_kernel=False``, the sequential plain version runs. Decode steps the
same scan at S = 1 from the cached state, where the reference writes the
step out by hand.

Numerics, as in the reference: the serving cache keeps the conv and ssm
states in the compute type, so in bf16 the fp32 state is rounded to bf16
after the prefill and after every decode step. A decode step updates its
cache's leaves in place. Under a mesh the in-projection's xs and z halves
stay sharded on channels over "model" (``regions.gated_product``); the
conv, ``x_proj``, delta and the scan run on each rank's channels
(``_conv_region``, ``_x_proj_region``, ``_delta_region``, ``_scan_region``),
taking the leaves the reference keeps whole (``x_proj``, ``dt_bias``,
``A_log``, ``D``) whole, so their gradients are partial sums, not
gathers; a decode step writes its new states back into the cache's own
placement (``regions.write``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import regions
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.models.layers import dense_init

Cache = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 8)
    return d_inner, m.d_state, m.d_conv, dt_rank


class Mamba(nn.Module):
    """Mamba weights, named as the JAX package's leaves."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        di, n, dc, dtr = _dims(cfg)
        dev = generator.device

        def param(shape, scale=None):
            return nn.Parameter(dense_init(shape, generator, dtype, scale))

        self.in_proj = param((d, 2 * di))
        self.conv_w = param((dc, di), scale=0.5)
        self.conv_b = nn.Parameter(torch.zeros(di, dtype=dtype, device=dev))
        self.x_proj = param((di, dtr + 2 * n))
        self.dt_proj = param((dtr, di))
        self.dt_bias = nn.Parameter(torch.full((di,), -4.6, dtype=dtype,
                                               device=dev))  # softplus ~0.01
        a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=dev))
        self.A_log = nn.Parameter(a_log.expand(di, n).to(dtype).contiguous())
        self.D = nn.Parameter(torch.ones(di, dtype=dtype, device=dev))
        self.out_proj = param((di, d))


def _ssm_inputs(p: Mamba, xs: torch.Tensor, cfg: ModelConfig):
    """xs: (B, S, d_inner) post-conv/act -> delta (B, S, d_inner) and A
    (d_inner, n) in float32, B and C (B, S, n) in the compute type."""
    _, n, _, dtr = _dims(cfg)
    proj = _x_proj_region(p, xs) if regions.is_dtensor(xs) \
        else xs @ p.x_proj.to(xs.dtype)
    dt, bmat, cmat = proj.split([dtr, n, n], dim=-1)
    delta = _delta_region(p, dt) if regions.is_dtensor(dt) \
        else _delta(dt, p.dt_proj, p.dt_bias)
    a = -torch.exp(p.A_log.float())
    return delta, a, bmat, cmat


def _own_channels(mesh, ch, n: int, *ts):
    """This rank's ``n`` channels (dim 0) of each of ``ts``, tensors whole
    over "model" (replicated leaves: ``x_proj``, ``dt_bias``, ``A``,
    ``D``), where ``ch`` says "model" splits the channels. A region takes
    such a leaf whole and its gradient as a partial sum over "model"
    (``regions.run_local``): sharding it at the region's entry would
    gather the gradient back in the backward."""
    if not ch:
        return ts
    lo = regions.model_rank(mesh) * n
    return tuple(t[lo:lo + n] for t in ts)


def _x_proj_region(p: Mamba, xs: torch.Tensor) -> torch.Tensor:
    """``xs @ x_proj`` on each rank's channels, a partial sum over
    "model": each rank multiplies its rows of ``x_proj``."""
    mesh, dp, ch = regions.split_entries(xs, 2)

    def local(xs, w):
        w, = _own_channels(mesh, ch, xs.shape[2], w)
        return xs @ w.to(xs.dtype)

    place = regions.place
    return regions.run_local(
        local, mesh, [place(mesh, (dp, None, ch)), place(mesh, (None, None))],
        place(mesh, (dp, None, None), partial=("model",) if ch else ()),
        xs, p.x_proj)


def _delta(dt, dt_proj, dt_bias) -> torch.Tensor:
    # jax.nn.softplus is log1p(exp(x)); F.softplus returns x above 20,
    # which is the same to float32 precision
    return F.softplus((dt @ dt_proj.to(dt.dtype)).float() + dt_bias.float())


def _delta_region(p: Mamba, dt: torch.Tensor) -> torch.Tensor:
    """``_delta`` on each rank's channels, from the whole low-rank dt: the
    channels' gradient then keeps their sharding through the backward
    (DTensor's own choice there can shard the sequence and fail to
    flatten it)."""
    mesh = dt.device_mesh
    tp = regions.model_size(mesh)
    dp = regions.entry(regions.batch_axes(mesh, dt.shape[0]))
    ch = "model" if tp > 1 and p.dt_proj.shape[1] % tp == 0 else None

    def local(dt, dt_proj, dt_bias):
        dt_bias, = _own_channels(mesh, ch, dt_proj.shape[1], dt_bias)
        return _delta(dt, dt_proj, dt_bias)

    place = regions.place
    return regions.run_local(
        local, mesh, [place(mesh, (dp, None, None)),
                      place(mesh, (None, ch)), place(mesh, (None,))],
        place(mesh, (dp, None, ch)), dt, p.dt_proj, p.dt_bias)


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    s, dc = x.shape[1], conv_w.shape[0]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    w = conv_w.to(x.dtype)
    out = pad[:, 0:s] * w[0]
    for i in range(1, dc):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + conv_b.to(x.dtype))


def _scan(xc, delta, a, bmat, cmat, dvec, state0, use_kernel: bool):
    if use_kernel and xc.is_cuda:
        return mamba_scan(xc, delta, a, bmat, cmat, dvec, state0)
    return mamba_scan_ref(xc, delta, a, bmat, cmat, dvec, state0)


def _conv_region(p: Mamba, xs: torch.Tensor) -> torch.Tensor:
    """The causal conv on each rank's channels (a DTensor's padding has no
    sharding rule)."""
    mesh, dp, ch = regions.split_entries(xs, 2)
    x_pl = regions.place(mesh, (dp, None, ch))
    return regions.run_local(
        _causal_conv, mesh, [x_pl, regions.place(mesh, (None, ch)),
                             regions.place(mesh, (ch,))],
        x_pl, xs, p.conv_w, p.conv_b)


def _conv_step(conv: torch.Tensor, xs: torch.Tensor, conv_w: torch.Tensor,
               conv_b: torch.Tensor):
    """One decode step of the causal conv: the cached ``dc - 1`` inputs
    and this one's -> (the activation (B, 1, di), the new cached inputs)."""
    conv_st = torch.cat([conv.to(xs.dtype), xs], dim=1)
    # the einsum may come back strided on a card, and the kernel reads x
    # in place
    xc = F.silu(torch.einsum("bci,ci->bi", conv_st, conv_w.to(xs.dtype))
                + conv_b.to(xs.dtype))[:, None].contiguous()
    return xc, conv_st[:, 1:]


def _conv_step_region(p: Mamba, conv: torch.Tensor, xs: torch.Tensor):
    """``_conv_step`` on each rank's channels (the cached inputs and this
    step's, concatenated, have no sharding rule across placements)."""
    mesh, dp, ch = regions.split_entries(xs, 2)
    x_pl = regions.place(mesh, (dp, None, ch))
    return regions.run_local(
        _conv_step, mesh, [x_pl, x_pl, regions.place(mesh, (None, ch)),
                           regions.place(mesh, (ch,))],
        (x_pl, x_pl), conv, xs, p.conv_w, p.conv_b)


def _scan_region(xc, delta, a, bmat, cmat, dvec, state0, use_kernel: bool):
    """The selective scan on each rank's channels, from ``state0`` (a
    decode step's cached state) or zeros: the kernel never sees a
    DTensor."""
    mesh, dp, ch = regions.split_entries(xc, 2)
    place = regions.place
    x_pl = place(mesh, (dp, None, ch))
    bc_pl = place(mesh, (dp, None, None))
    st_pl = place(mesh, (dp, ch, None))

    def local(xc, delta, a, bmat, cmat, dvec, state0):
        a, dvec = _own_channels(mesh, ch, xc.shape[2], a, dvec)
        return _scan(xc, delta, a, bmat, cmat, dvec, state0, use_kernel)

    return regions.run_local(
        local, mesh, [x_pl, x_pl, place(mesh, (None, None)), bc_pl, bc_pl,
                      place(mesh, (None,)), None if state0 is None else st_pl],
        (x_pl, st_pl), xc, delta, a, bmat, cmat, dvec, state0)


def mamba_forward(p: Mamba, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[Cache] = None, return_state: bool = False,
                  use_kernel: bool = True):
    """x: (B, S, d). Without ``cache`` a prefill (returning the conv and
    ssm states when ``return_state``); with ``cache`` ({"conv": (B, dc-1,
    di), "ssm": (B, di, n)}) one decode step, which writes the new states
    into the cache in place."""
    _, _, dc, _ = _dims(cfg)
    s = x.shape[1]
    xs, z = regions.gated_product(x, p.in_proj)

    new_cache = None
    sharded = regions.is_dtensor(xs)
    if cache is not None:
        assert s == 1, "cache path is a single decode step"
        xc, conv_new = (_conv_step_region(p, cache["conv"], xs) if sharded
                        else _conv_step(cache["conv"], xs, p.conv_w,
                                        p.conv_b))
        state0 = cache["ssm"].float()
    else:
        state0 = None
        xc = _conv_region(p, xs) if sharded \
            else _causal_conv(xs, p.conv_w, p.conv_b)
    delta, a, bmat, cmat = _ssm_inputs(p, xc, cfg)
    scan = _scan_region if sharded else _scan
    y, h = scan(xc, delta, a, bmat, cmat, p.D, state0, use_kernel)
    if cache is not None:
        regions.write(cache["conv"], conv_new)
        regions.write(cache["ssm"], h)
        new_cache = cache
    elif return_state:
        new_cache = {"conv": xs[:, -(dc - 1):].to(x.dtype),
                     "ssm": h.to(x.dtype)}
    out = (y * F.silu(z.float())).to(x.dtype) @ p.out_proj.to(x.dtype)
    return out, new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Cache:
    di, n, dc, _ = _dims(cfg)
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, n), dtype=dtype, device=device)}
