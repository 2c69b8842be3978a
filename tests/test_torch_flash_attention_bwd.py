"""The flash-attention backward on the CPU: the backward kernel's tiled
algorithm, emulated in plain torch, and the op's CPU route against the JAX
package's VJP (``jax.vjp`` of ``repro.kernels.flash_attention.ops.
flash_attention``: its forward the Pallas kernel in interpret mode, its
backward the VJP of its oracle); the plain version's log-sum-exp; the
backward wrapper's input checks, its split of a GQA group and its
workspace; the backward op in a fake-tensor trace; the kernel libraries'
build hash over their shared header. Inputs are made from a numpy seed."""
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFunction,
    flash_attention,
    flash_bwd_flops,
    flash_bwd_plain,
    flash_flops,
    flash_pairs,
    flash_plain,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# (JAX type, torch type, tolerance of max |reference|): fp32 to float
# noise (sums in another order); bf16 as the forward's kernel test (P and
# dS rounded to bf16 for their products on the tensor-core path, every
# gradient rounded to bf16)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# the CUDA-core kernels' tiles (csrc/flash_attention_bwd.cu): keys and
# query rows; the tensor-core kernel's are kernel.TC_BWD_TILES by head_dim
SIMT_TILES = (32, 32)

# (B, Hq, Hkv, Sq, Skv, dh, causal): GQA groups 1, 4 and 12; Sq <, = and >
# Skv, causal and not; head_dim 64, 128, 192 and a ragged 40; lengths that
# are not a multiple of either path's tile (the JAX kernel takes any
# length up to its 128-row block)
CASES = [
    (2, 4, 4, 128, 128, 64, True),
    (1, 4, 1, 96, 128, 128, True),       # causal Sq < Skv
    (1, 12, 1, 128, 96, 128, True),      # causal Sq > Skv, group 12
    (2, 4, 1, 100, 100, 192, True),      # MLA's head_dim, ragged S
    (1, 12, 1, 64, 128, 192, False),     # non-causal Sq < Skv
    (1, 4, 4, 128, 80, 64, False),       # non-causal Sq > Skv
    (1, 8, 2, 100, 100, 40, True),       # ragged head_dim: the CUDA cores
    (2, 4, 1, 33, 77, 40, False),
]
# the tensor-core path's own cases (bf16): GQA groups that it splits over
# blocks (bwd_parts 12 and 6 at a short SL); causal key tiles past the last
# query (Sq < Skv), whose dK and dV are 0; several key tiles a dQ tile,
# added from the diagonal's down (causal) or in order (lengths beyond 128
# are multiples of it, as the JAX kernel takes them)
TC_CASES = [
    (2, 12, 1, 48, 48, 128, True),       # group 12 split a head a block
    (2, 12, 2, 64, 64, 64, False),       # group 6 split a head a block
    (1, 4, 2, 128, 256, 64, True),       # key tile 1 past every query
    (1, 2, 1, 128, 256, 192, True),      # key tiles 2, 3 past every query
    (1, 4, 2, 256, 256, 128, True),      # 4 query tiles over 2 key tiles
    (1, 2, 2, 256, 256, 64, False),      # key tiles 0 then 1 a dQ tile
]


def _arrays(seed, b, hq, hkv, sq, skv, dh):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, hq, dh).astype(np.float32),
            r.randn(b, skv, hkv, dh).astype(np.float32),
            r.randn(b, skv, hkv, dh).astype(np.float32),
            r.randn(b, sq, hq, dh).astype(np.float32))


def emulate_bwd(q, k, v, o, lse, g, causal):
    """The backward kernel's algorithm in plain torch, in the (B, S, H, dh)
    layout, with the tiles of the path ``select_path`` gives (keys BK and
    query rows BQ): D = rowsum(g o o); P recomputed from lse a (query tile,
    key tile) pair at a time, dS = P (dP - D). dK and dV: a block per (key
    tile, part of the GQA group: ``bwd_parts`` on the tensor-core path, the
    whole group on the CUDA cores) sums, in its walk's order, dV += P^T dO
    and dK += dS^T Q over its heads and, per head, its query tiles (from
    the diagonal's, causal; none for a key tile past the last query; not
    causal on the tensor cores, from its own, key tile kt's walk starting
    at query tile kt, where there are no more key tiles than query tiles);
    the parts are summed in order. dQ, per query tile, sums dS K over its
    key tiles in the kernel's fixed order: on the tensor-core path causal
    from the last key tile that meets the query tile down to 0, else in the
    order the walks reach it (key tiles 0 up where they do not start
    apart); on the CUDA cores 0 up. On the tensor-core path P and dS are
    rounded to bf16 for their products, as the kernel rounds them; sums
    stay fp32."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    path = kernel.select_path(q.dtype, dh)
    bk, bq = kernel.TC_BWD_TILES[dh] if path == "tc" else SIMT_TILES
    parts = kernel.bwd_parts(b, hq, hkv, sq, skv, dh) if path == "tc" else 1

    def rnd(x):
        return x.to(torch.bfloat16).float() if path == "tc" else x
    scale = 1.0 / math.sqrt(dh)
    qf, of, gf = (t.float().transpose(1, 2) for t in (q, o, g))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(group, 1)
              for t in (k, v))
    dsum = (gf * of).sum(-1)                          # (B, Hq, Sq)
    n_qt, n_kt = -(-sq // bq), -(-skv // bk)

    staggered = path == "tc" and not causal and n_kt <= min(n_qt,
                                                            kernel.SMS)

    def walk(kt):
        """The query tiles of key tile kt's block, in its order."""
        if causal:
            return [] if kt * bk > sq - 1 else list(range(kt * bk // bq,
                                                          n_qt))
        start = kt if staggered else 0
        return [(start + i) % n_qt for i in range(n_qt)]

    def tile(qt, kt):
        qs, ks = slice(qt * bq, qt * bq + bq), slice(kt * bk, kt * bk + bk)
        s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
        qpos = torch.arange(qt * bq, min(qt * bq + bq, sq))[:, None]
        kpos = torch.arange(kt * bk, min(kt * bk + bk, skv))[None, :]
        live = ~(kpos > qpos) if causal else torch.ones_like(kpos > qpos)
        p = torch.where(live, torch.exp(s * scale - lse[:, :, qs, None]),
                        torch.zeros(()))
        dp = gf[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
        ds = p * (dp - dsum[:, :, qs, None])
        return rnd(p), rnd(ds)

    pairs = {(qt, kt): tile(qt, kt) for kt in range(n_kt) for qt in walk(kt)}
    dq = torch.zeros(b, hq, sq, dh)
    for qt in range(n_qt):
        qs = slice(qt * bq, qt * bq + bq)
        kts = [kt for kt in range(n_kt) if (qt, kt) in pairs]
        if path == "tc" and causal:
            kts = kts[::-1]
        elif staggered:
            kts.sort(key=lambda kt: (qt - kt) % n_qt)
        for kt in kts:
            dq[:, :, qs] += pairs[qt, kt][1] @ kf[:, :, kt * bk:kt * bk + bk]
    # heads as (KV head, part, head in part)
    gp = group // parts
    dk = torch.zeros(b, hkv, skv, dh)
    dv = torch.zeros(b, hkv, skv, dh)
    for kt in range(n_kt):
        ks = slice(kt * bk, kt * bk + bk)
        acc_k = torch.zeros(b, hkv, parts, min(bk, skv - kt * bk), dh)
        acc_v = torch.zeros_like(acc_k)
        for i in range(gp):
            for qt in walk(kt):
                qs = slice(qt * bq, qt * bq + bq)
                p, ds = (x.unflatten(1, (hkv, parts, gp))[:, :, :, i]
                         for x in pairs[qt, kt])
                acc_v += p.transpose(-1, -2) @ gf[:, :, qs].unflatten(
                    1, (hkv, parts, gp))[:, :, :, i]
                acc_k += ds.transpose(-1, -2) @ qf[:, :, qs].unflatten(
                    1, (hkv, parts, gp))[:, :, :, i]
        for pt in range(parts):
            dk[:, :, ks] += acc_k[:, :, pt]
            dv[:, :, ks] += acc_v[:, :, pt]

    def out(x, dt):
        return x.transpose(1, 2).contiguous().to(dt)
    return out(dq * scale, q.dtype), out(dk * scale, k.dtype), \
        out(dv, k.dtype)


def _jax_vjp(arrays, jdt, causal):
    q, k, v, g = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal), q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(g)]


def _assert_close(got, want, tol):
    """Every gradient within ``tol`` of its max |reference|."""
    for gt, w in zip(got, want):
        gt = gt.float().numpy()
        assert gt.shape == w.shape
        scale = np.abs(w).max()
        assert np.abs(gt - w).max() <= tol * scale, \
            (np.abs(gt - w).max(), scale)


def _check_tiled(b, hq, hkv, sq, skv, dh, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _arrays(sq + 7 * hq + dh, b, hq, hkv, sq, skv, dh)
    want = _jax_vjp(arrays, jdt, causal)
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in arrays)
    o, lse = flash_plain(q, k, v, causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    _assert_close(emulate_bwd(q, k, v, o, lse, g, causal), want, tol)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*ts, causal=causal), ts, g)
    _assert_close(got, want, tol)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_backward_matches_jax_vjp(b, hq, hkv, sq, skv, dh, causal,
                                        dtype):
    """The kernel's tiled backward, from the plain forward's o and lse,
    against ``jax.vjp`` of the JAX op; and the op's CPU backward (the plain
    VJP) against the same."""
    _check_tiled(b, hq, hkv, sq, skv, dh, causal, dtype)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", TC_CASES)
def test_tiled_backward_splits_and_orders_as_the_kernel(b, hq, hkv, sq, skv,
                                                        dh, causal):
    """The same at the tensor-core path's own cases in bf16: a GQA group
    split over blocks (its parts of dK and dV summed in order), dQ's tiles
    summed over several key tiles in the kernel's order, key tiles that no
    query meets."""
    if causal and sq < skv:
        bk = kernel.TC_BWD_TILES[dh][0]
        assert -(-skv // bk) * bk > sq        # some key tile is past Sq
    if hkv < hq and skv < 128:
        assert kernel.bwd_parts(b, hq, hkv, sq, skv, dh) == hq // hkv
    _check_tiled(b, hq, hkv, sq, skv, dh, causal, "bfloat16")


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", CASES[:4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_lse_matches_float64_scores(b, hq, hkv, sq, skv, dh, causal,
                                          dtype):
    """The plain version's log-sum-exp, what the forward kernel writes
    beside o, against a float64 log-sum-exp of the JAX reference's scores
    (q k^T / sqrt(dh), KV heads repeated, the top-left mask at -1e30) on
    the same (type-rounded) inputs."""
    _, tdt, _ = DTYPES[dtype]
    q, k, v, _ = (torch.from_numpy(a).to(tdt)
                  for a in _arrays(sq + dh, b, hq, hkv, sq, skv, dh))
    _, lse = flash_plain(q, k, v, causal)
    q64, k64 = (t.double().numpy() for t in (q, k))
    k64 = np.repeat(k64, hq // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q64, k64) / math.sqrt(dh)
    if causal:
        s = np.where(np.arange(skv)[None, :] <= np.arange(sq)[:, None], s,
                     -1e30)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def _counts():
    return (kernel.launches, kernel.launches_tc, kernel.launches_simt,
            kernel.bwd_launches, kernel.bwd_launches_tc,
            kernel.bwd_launches_simt, ops.plain_cuda_calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_backward_on_cpu_is_the_plain_vjp_and_no_kernel(dtype):
    """On the CPU the op's gradients are ``flash_bwd_plain``'s to the bit,
    on strided slices of a projection as the models give them, and no
    launch counter moves (nor the plain VJP's count of CUDA calls)."""
    r = np.random.RandomState(3)
    b, s, hq, hkv, dh = 2, 48, 6, 2, 64
    proj = torch.tensor(r.randn(b, s, (hq + 2 * hkv) * dh), dtype=dtype)
    q, k, v = (t.unflatten(-1, (-1, dh)) for t in proj.split(
        [hq * dh, hkv * dh, hkv * dh], dim=-1))
    g = torch.tensor(r.randn(b, s, hq, dh), dtype=dtype)
    before = _counts()
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*ts), ts, g)
    want = flash_bwd_plain(q, k, v, g)
    assert _counts() == before
    for gt, w, t in zip(got, want, (q, k, v)):
        assert gt.dtype == t.dtype and gt.shape == t.shape
        torch.testing.assert_close(gt, w, rtol=0, atol=0)


def _bwd_args(dtype, dh, hq=12, hkv=1, sq=48, skv=48, b=2):
    """q, k, v as slices of one (B, S, (Hq + 2 Hkv) dh) projection, o and
    g contiguous and lse, as the op hands them to the wrapper."""
    proj = torch.zeros(b, sq, (hq + 2 * hkv) * dh, dtype=dtype)
    q = proj[..., :hq * dh].unflatten(-1, (hq, dh))
    k = proj[..., hq * dh:(hq + hkv) * dh].unflatten(-1, (hkv, dh))
    v = proj[..., (hq + hkv) * dh:].unflatten(-1, (hkv, dh))
    return [q, k, v, torch.zeros(b, sq, hq, dh, dtype=dtype),
            torch.zeros(b, hq, sq), torch.zeros(b, sq, hq, dh, dtype=dtype)]


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 192),
                                      (torch.float32, 128),
                                      (torch.float32, 192),
                                      (torch.bfloat16, 40)])
def test_check_bwd_inputs_takes_the_models_layouts(dtype, dh):
    """The models' strided q, k and v with o, lse and a contiguous g pass,
    with the path ``select_path`` gives; so does an MLA-like g cut from a
    wider cotangent on the CUDA-core path. No card needed."""
    args = _bwd_args(dtype, dh)
    want = kernel.select_path(dtype, dh)
    assert kernel.check_bwd_inputs(*args) == want
    assert kernel.check_bwd_inputs(
        *(t.contiguous() for t in args)) == want
    one = torch.zeros(1, 1, 1, dh, dtype=dtype)
    assert kernel.check_bwd_inputs(one, one, one, one,
                                   torch.zeros(1, 1, 1), one) == want


def _refused(case):
    args = _bwd_args(torch.bfloat16, 64, hq=4, hkv=2, sq=16, skv=16)
    q, k, v, o, lse, g = args
    if case == "o type":
        o = o.float()
    elif case == "g shape":
        g = g[:, :8]
    elif case == "g head dim strided":
        g = g.transpose(1, 3).contiguous().transpose(1, 3)
    elif case == "g unaligned":
        g = torch.zeros(2, 16, 4, 65, dtype=torch.bfloat16)[..., 1:]
    elif case == "lse type":
        lse = lse.double()
    elif case == "lse shape":
        lse = lse[:, :, :8]
    elif case == "lse strided":
        lse = torch.zeros(2, 16, 4).transpose(1, 2)
    elif case == "groups":
        k = v = torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16)
    else:
        raise AssertionError(case)
    return q, k, v, o, lse, g


@pytest.mark.parametrize("case,match", [
    ("o type", "o is"), ("g shape", "g is"),
    ("g head dim strided", "not contiguous"), ("g unaligned", "16-byte"),
    ("lse type", "lse must"), ("lse shape", "lse must"),
    ("lse strided", "lse must"), ("groups", "shapes disagree"),
])
def test_check_bwd_inputs_refuses_what_the_kernel_does_not_take(case, match):
    with pytest.raises(ValueError, match=match):
        kernel.check_bwd_inputs(*_refused(case))


def test_backward_wrapper_refuses_cpu_tensors():
    args = _bwd_args(torch.float32, 64)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.flash_attention_bwd(*args)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._backward(*(t.to("meta") for t in args), True)


class _Ctx:
    """What an autograd.Function's forward and backward use of ``ctx``."""

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


@pytest.mark.parametrize("causal", [True, False])
def test_backward_op_follows_a_fake_trace(causal):
    """The op's forward and backward on fake CUDA tensors (called as
    autograd calls them: autograd itself aborts on fake CUDA tensors in a
    CPU-only torch): one fake call each, no launch, the gradients in the
    inputs' shapes and types, and ``FlopCounterMode`` reads both
    formulas: the tensor-core backward's 10 dh operations a scored pair."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, sq, skv, hq, hkv, dh = 2, 48, 80, 8, 2, 128
    bf = torch.bfloat16
    kernel.fake_calls = kernel.bwd_fake_calls = 0
    before = _counts()
    with FakeTensorMode():
        q = torch.empty(b, sq, hq, dh, dtype=bf, device="cuda")
        k = torch.empty(b, skv, hkv, dh, dtype=bf, device="cuda")
        v = torch.empty_like(k)
        with FlopCounterMode(display=False) as fc:
            ctx = _Ctx()
            o = FlashAttentionFunction.forward(ctx, q, k, v, causal)
            grads = FlashAttentionFunction.backward(ctx, torch.empty_like(o))
    assert (kernel.fake_calls, kernel.bwd_fake_calls) == (1, 1)
    assert _counts() == before
    assert grads[3] is None
    for gt, t in zip(grads, (q, k, v)):
        assert (gt.device.type, gt.dtype, gt.shape) == ("cuda", bf, t.shape)
    saved = ctx.saved_tensors
    assert saved[3].shape == q.shape and saved[4].shape == (b, hq, sq)
    assert saved[4].dtype == torch.float32
    assert fc.get_total_flops() == flash_flops(b, hq, sq, skv, dh, causal) \
        + flash_bwd_flops(b, hq, sq, skv, dh, causal)
    assert flash_bwd_flops(b, hq, sq, skv, dh, causal) == b * hq * dh * (
        10 * flash_pairs(sq, skv, causal) + 2 * sq)


@pytest.mark.parametrize("dtype,dh,path,per_pair", [
    (torch.bfloat16, 128, "tc", 10), (torch.bfloat16, 192, "tc", 10),
    (torch.float32, 128, "simt", 14), (torch.bfloat16, 40, "simt", 14),
])
def test_backward_op_allocates_the_wrappers_workspace(dtype, dh, path,
                                                      per_pair):
    """The backward op on fake CUDA tensors returns, beside the gradients,
    the float32 workspace that the wrapper allocates (``bwd_workspace`` of
    the path), so a traced step holds the bytes the card does; and the
    operations it counts are its path's kernel's own (10 dh a scored pair
    on the tensor cores, 14 on the CUDA cores)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, sq, skv, hq, hkv = 2, 144, 144, 24, 2
    with FakeTensorMode():
        q = torch.empty(b, sq, hq, dh, dtype=dtype, device="cuda")
        k = torch.empty(b, skv, hkv, dh, dtype=dtype, device="cuda")
        lse = torch.empty(b, hq, sq, device="cuda")
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.flash_attention_bwd(
                q, k, k, q, lse, q, True)
    assert len(out) == 4
    assert out[3].dtype == torch.float32 and out[3].shape == (
        kernel.bwd_workspace(b, hq, hkv, sq, skv, dh, path),)
    assert fc.get_total_flops() == flash_bwd_flops(
        b, hq, sq, skv, dh, True, path) == b * hq * dh * (
        per_pair * flash_pairs(sq, skv, True) + 2 * sq)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,parts", [
    (8, 24, 2, 144, 144, 128, 6),     # starcoder2-3b at SL 144: 32 -> 192
    (8, 24, 2, 64, 64, 128, 12),      # ... at SL 64: 16 -> 192
    (8, 24, 2, 2816, 2816, 128, 4),   # ... at SL 2816: 352 blocks, but 12
    (8, 24, 2, 4096, 4096, 128, 4),   #   heads' dQ a block would leave L2
    (8, 32, 8, 144, 144, 128, 2),     # jamba's attention: 128 -> 256
    (8, 16, 16, 1500, 1500, 64, 1),   # whisper's encoder: group 1
    (8, 128, 128, 144, 144, 192, 1),  # deepseek-v3's MLA: group 1
    (1, 4, 1, 96, 128, 128, 4),       # too few blocks even a head a block
])
def test_bwd_parts_split_a_group_until_the_grid_fills_the_card(
        b, hq, hkv, sq, skv, dh, parts):
    """``bwd_parts``: the least divisor of the GQA group that gives (b, KV
    head, key tile, part) at least ``SMS`` blocks and keeps the dQ of the
    blocks on the card at once within ``L2_BUDGET``, else a head a
    block."""
    assert kernel.bwd_parts(b, hq, hkv, sq, skv, dh) == parts
    bk, bq = kernel.TC_BWD_TILES[dh]
    n_kt = -(-skv // bk)
    group = hq // hkv
    assert group % parts == 0
    held = min(kernel.SMS // n_kt, b * hkv * parts)
    fits = group // parts * -(-sq // bq) * bq * dh * 4 * held \
        <= kernel.L2_BUDGET
    assert (b * hkv * n_kt * parts >= kernel.SMS and fits) \
        or parts == group


def test_bwd_workspace_follows_the_kernels_layout():
    """The workspace in float32 elements: the CUDA-core path's D; the
    tensor-core path's lse and D on rows padded to whole query tiles, a
    counter a dQ tile (rounded up to 4), dQ's tiles and, where a group is
    split, the parts of dK and dV."""
    assert kernel.bwd_workspace(2, 8, 2, 100, 90, 40, "simt") == 2 * 8 * 100
    # dh 128: 64-row query tiles, 2 of them; group 4 over 2 x 2 x 1 key
    # tiles: split into 4 parts
    b, hq, hkv, sq, skv, dh = 2, 8, 2, 100, 90, 128
    assert kernel.bwd_parts(b, hq, hkv, sq, skv, dh) == 4
    tiles = b * hq * 2
    assert kernel.bwd_workspace(b, hq, hkv, sq, skv, dh, "tc") == (
        2 * b * hq * 128 + tiles + tiles * 64 * dh
        + 2 * 4 * b * skv * hkv * dh)
    # dh 64 at whisper's encoder: 128-row tiles, no split
    assert kernel.bwd_workspace(8, 16, 16, 1500, 1500, 64, "tc") == (
        2 * 8 * 16 * 1536 + 8 * 16 * 12 + 8 * 16 * 12 * 128 * 64)


def test_library_hash_covers_the_headers_a_source_includes(tmp_path):
    """``_build.library_path`` names a library by a hash of its sources and
    of the headers they include with ``#include "..."`` (through headers'
    own includes): editing a header gives another library, so a stale one
    is never loaded. The flash kernels' sources both include
    ``csrc/hopper.cuh``."""
    src, head, inner = (tmp_path / n for n in ("k.cu", "k.cuh", "in.cuh"))
    src.write_text('#include "k.cuh"\nint main() { return F; }\n')
    head.write_text('#include "in.cuh"\n#define F 0\n')
    inner.write_text("// 1\n")
    first = _build.library_path("k", (str(src),))[0]
    assert _build.library_path("k", (str(src),))[0] == first
    head.write_text('#include "in.cuh"\n#define F 1\n')
    second = _build.library_path("k", (str(src),))[0]
    inner.write_text("// 2\n")
    third = _build.library_path("k", (str(src),))[0]
    assert len({first, second, third}) == 3
    assert os.path.dirname(first) == _build.BUILD_DIR
    header = os.path.join(os.path.dirname(kernel.SOURCE), "hopper.cuh")
    for source in (kernel.SOURCE, kernel.SOURCE_BWD):
        assert [os.path.realpath(f) for f in _build._files((source,))] \
            == [os.path.realpath(f) for f in (source, header)]


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    return cs


@pytest.mark.parametrize("causal", [True, False])
def test_card_bound_takes_what_the_function_needs(monkeypatch, chip_smoke,
                                                  causal):
    """``chip_smoke.flash_bwd_bound_ms`` counts 8 dh operations a scored
    pair (dV, dP, dS K and dS^T Q), less than the kernel's own 10 dh, and
    q, k, v, o, dO and lse read once and dq, dk, dv written once."""
    b, sq, skv, hq, hkv, dh = 2, 48, 80, 8, 2, 128
    bf = torch.bfloat16
    ms, by, nbytes, flops = chip_smoke.flash_bwd_bound_ms(
        b * hq, b * hkv, sq, skv, dh, causal, bf)
    assert flops == 8 * b * hq * dh * flash_pairs(sq, skv, causal) \
        < flash_bwd_flops(b, hq, sq, skv, dh, causal)
    # q, o, dO, dq; k, v, dk, dv; lse in fp32
    assert nbytes == 2 * dh * (4 * b * hq * sq + 4 * b * hkv * skv) \
        + 4 * b * hq * sq
    monkeypatch.setattr(chip_smoke, "HBM_BYTES_PER_S", float("inf"))
    ms, by = chip_smoke.flash_bwd_bound_ms(b * hq, b * hkv, sq, skv, dh,
                                           causal, bf)[:2]
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flops / chip_smoke.BF16_FLOPS_PER_S,
                               rel=1e-12)
