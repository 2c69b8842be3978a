"""The flash-attention backward on the CPU: the backward kernel's tiled
algorithm, emulated in plain torch, and the op's CPU route against the JAX
package's VJP (``jax.vjp`` of ``repro.kernels.flash_attention.ops.
flash_attention``: its forward the Pallas kernel in interpret mode, its
backward the VJP of its oracle); the plain version's log-sum-exp; the
backward wrapper's input checks; the backward op in a fake-tensor trace.
Inputs are made from a numpy seed."""
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
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
# the kernel's tiles (csrc/flash_attention_bwd.cu): query rows and keys a
# tile on each path
TILES = {"tc": 64, "simt": 32}

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


def _arrays(seed, b, hq, hkv, sq, skv, dh):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, hq, dh).astype(np.float32),
            r.randn(b, skv, hkv, dh).astype(np.float32),
            r.randn(b, skv, hkv, dh).astype(np.float32),
            r.randn(b, sq, hq, dh).astype(np.float32))


def emulate_bwd(q, k, v, o, lse, g, causal):
    """The backward kernel's algorithm in plain torch, in the (B, S, H, dh)
    layout, with the tiles of the path ``select_path`` gives: D =
    rowsum(g o o); (b) per key tile, the query tiles at or below the
    diagonal, P recomputed from lse, dV += P^T dO, dK += dS^T Q, the GQA
    group summed; (c) per query tile, the key tiles up to the diagonal,
    dQ += dS K. On the tensor-core path P and dS are rounded to bf16 for
    their products, as the kernel rounds them; sums stay fp32."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    path = kernel.select_path(q.dtype, dh)
    bq = bk = TILES[path]

    def rnd(x):
        return x.to(torch.bfloat16).float() if path == "tc" else x
    scale = 1.0 / math.sqrt(dh)
    qf, of, gf = (t.float().transpose(1, 2) for t in (q, o, g))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(group, 1)
              for t in (k, v))
    dsum = (gf * of).sum(-1)                          # (B, Hq, Sq)

    def tile(q0, k0):
        qs, ks = slice(q0, q0 + bq), slice(k0, k0 + bk)
        s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
        qpos = torch.arange(q0, min(q0 + bq, sq))[:, None]
        kpos = torch.arange(k0, min(k0 + bk, skv))[None, :]
        live = ~(kpos > qpos) if causal else torch.ones_like(kpos > qpos)
        p = torch.where(live, torch.exp(s * scale - lse[:, :, qs, None]),
                        torch.zeros(()))
        dp = gf[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
        ds = p * (dp - dsum[:, :, qs, None])
        return qs, ks, rnd(p), rnd(ds)

    dq = torch.zeros(b, hq, sq, dh)
    dk = torch.zeros(b, hq, skv, dh)
    dv = torch.zeros(b, hq, skv, dh)
    for k0 in range(0, skv, bk):
        for q0 in range((k0 // bq) * bq if causal else 0, sq, bq):
            qs, ks, p, ds = tile(q0, k0)
            dv[:, :, ks] += p.transpose(-1, -2) @ gf[:, :, qs]
            dk[:, :, ks] += ds.transpose(-1, -2) @ qf[:, :, qs]
    for q0 in range(0, sq, bq):
        end = min(skv, q0 + bq, sq) if causal else skv
        for k0 in range(0, end, bk):
            qs, ks, _, ds = tile(q0, k0)
            dq[:, :, qs] += ds @ kf[:, :, ks]

    def out(x, dt):
        return x.transpose(1, 2).contiguous().to(dt)
    dk = (dk * scale).unflatten(1, (hkv, group)).sum(2)
    dv = dv.unflatten(1, (hkv, group)).sum(2)
    return out(dq * scale, q.dtype), out(dk, k.dtype), out(dv, k.dtype)


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


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_backward_matches_jax_vjp(b, hq, hkv, sq, skv, dh, causal,
                                        dtype):
    """The kernel's tiled backward, from the plain forward's o and lse,
    against ``jax.vjp`` of the JAX op; and the op's CPU backward (the plain
    VJP) against the same."""
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
    formulas."""
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
        14 * flash_pairs(sq, skv, causal) + 2 * sq)


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
    pair (dV, dP, dS K and dS^T Q), less than the kernel's own 14 dh, and
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
