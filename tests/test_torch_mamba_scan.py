"""The port's selective scan (plain version and autograd op) against the JAX
package's Pallas kernel (interpret mode), its oracle, its op's VJP and its
model's decode arithmetic, on the CPU, with inputs made from a numpy seed.
Tolerances are the JAX package's kernel test's: 1e-4 in float32 (sums taken
in another order), 3e-2 in bfloat16 (the Pallas kernel rounds y to bf16;
the port keeps it in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.mamba_scan.kernel import mamba_scan_fwd as jax_kernel
from repro.kernels.mamba_scan.ops import mamba_scan as jax_op
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_ref
from repro.models import mamba as jmb
from repro_torch.configs import smoke_config
from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.ops import (
    mamba_scan,
    mamba_scan_bwd_plain,
)
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.models import mamba as tmb

F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, d, n):
    """x ~ N(0, 1), delta = softplus(N(0, 1) - 2), a = -exp(0.3 N(0, 1)),
    B, C, D ~ N(0, 1): the JAX package's kernel test's distributions."""
    r = np.random.RandomState(seed)
    x = r.randn(b, s, d)
    delta = np.log1p(np.exp(r.randn(b, s, d) - 2))
    a = -np.exp(r.randn(d, n) * 0.3)
    bm, cm = r.randn(b, s, n), r.randn(b, s, n)
    dd = r.randn(d)
    return [v.astype(np.float32) for v in (x, delta, a, bm, cm, dd)]


def _bf16(a):
    """Round to bfloat16 and back, so both sides see the same values."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _close(mine, want, tol=F32_TOL):
    np.testing.assert_allclose(mine.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,s,d,n,bd,chunk", [
    (2, 128, 128, 8, 128, 32), (1, 64, 256, 16, 128, 64),
    (2, 96, 64, 4, 64, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_kernel_and_oracle(b, s, d, n, bd, chunk, dtype):
    """The grid of the JAX package's kernel test. In bf16, x, delta, B and C
    are bf16 on both sides (A and D float32, as that test has them)."""
    x, delta, a, bm, cm, dd = _inputs(b + s + n, b, s, d, n)
    if dtype == "bfloat16":
        x, delta, bm, cm = (_bf16(v) for v in (x, delta, bm, cm))
        tdt, jdt, tol = torch.bfloat16, jnp.bfloat16, dict(rtol=3e-2,
                                                           atol=3e-2)
    else:
        tdt, jdt, tol = torch.float32, jnp.float32, F32_TOL
    y, st = mamba_scan_ref(*(torch.from_numpy(v).to(tdt) if i in (0, 1, 3, 4)
                             else torch.from_numpy(v)
                             for i, v in enumerate((x, delta, a, bm, cm,
                                                    dd))))
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (b, s, d) and st.shape == (b, d, n)
    jargs = [jnp.asarray(v, jdt) if i in (0, 1, 3, 4) else jnp.asarray(v)
             for i, v in enumerate((x, delta, a, bm, cm, dd))]
    _close(y, jax_kernel(*jargs, block_d=bd, chunk=chunk, interpret=True)
           .astype(jnp.float32), tol)
    _close(y, jax_ref(*jargs).astype(jnp.float32), tol)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_ragged_lengths_match_jax_oracle(s):
    """Lengths the Pallas kernel refuses (S % chunk != 0), against the JAX
    oracle, which takes any S."""
    arrays = _inputs(s, 2, s, 48, 16)
    y, _ = mamba_scan(*(torch.from_numpy(v) for v in arrays))
    _close(y, jax_ref(*(jnp.asarray(v) for v in arrays)))


def _jax_decode_steps(jp, cfg, xc, h):
    """The JAX model's decode arithmetic (``repro.models.mamba``'s cache
    branch), one step at a time from state ``h``: its ``_ssm_inputs``, then
    h = h * dA + dBx and y = <h, C> + D x."""
    ys = []
    for t in range(xc.shape[1]):
        xt = xc[:, t:t + 1]
        da, dbx, cmat = jmb._ssm_inputs(jp, xt, cfg)
        h = h * da[:, 0] + dbx[:, 0]
        y = jnp.einsum("bin,bn->bi", h, cmat[:, 0].astype(jnp.float32))
        ys.append(y + jp["D"].astype(jnp.float32) * xt[:, 0])
    return jnp.stack(ys, axis=1), h


@pytest.mark.parametrize("s", [1, 5])
def test_state_in_and_out_match_jax_decode_steps(s):
    """From a random state: the scan over S steps at once, and S scans of
    one step each chaining the state, give the JAX decode path's y and
    final state. delta, A, B and C come from each package's own
    ``_ssm_inputs`` on the same block weights."""
    jcfg, cfg = jax_smoke_config("jamba-v0.1-52b"), \
        smoke_config("jamba-v0.1-52b")
    jp = jmb.init_mamba(jax.random.PRNGKey(s), jcfg, jnp.float32)
    tp = tmb.Mamba(cfg, torch.Generator().manual_seed(0), torch.float32)
    tp.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()}, strict=True)
    di, n = 2 * cfg.d_model, cfg.mamba.d_state
    r = np.random.RandomState(s)
    xc = r.randn(2, s, di).astype(np.float32)
    h0 = r.randn(2, di, n).astype(np.float32)
    jy, jh = _jax_decode_steps(jp, jcfg, jnp.asarray(xc), jnp.asarray(h0))
    with torch.no_grad():
        txc = torch.from_numpy(xc)
        delta, a, bm, cm = tmb._ssm_inputs(tp, txc, cfg)
        y, h = mamba_scan(txc, delta, a, bm, cm, tp.D, torch.from_numpy(h0))
        _close(y, jy)
        _close(h, jh)
        h, ys = torch.from_numpy(h0), []
        for t in range(s):
            yt, h = mamba_scan(txc[:, t:t + 1], delta[:, t:t + 1], a,
                               bm[:, t:t + 1], cm[:, t:t + 1], tp.D, h)
            ys.append(yt)
        _close(torch.cat(ys, dim=1), jy)
        _close(h, jh)


def test_op_gradients_match_jax_vjp():
    """Loss sum(y * g), g fixed, through the JAX op (Pallas kernel in
    interpret mode, VJP of its oracle) and the port's op (VJP of its plain
    version): forward at 1e-4, gradients of x, delta, a, B, C and D at
    rtol 1e-4 / atol 1e-4. A loss linear in y keeps the forwards'
    difference out of the cotangent."""
    arrays = _inputs(3, 1, 64, 64, 8)
    g = np.random.RandomState(4).randn(1, 64, 64).astype(np.float32)
    jarrays = [jnp.asarray(v) for v in arrays]
    j_y = jax_op(*jarrays, 64, 32)
    j_grads = jax.grad(lambda *v: jnp.sum(jax_op(*v, 64, 32) * g),
                       argnums=tuple(range(6)))(*jarrays)
    ts = [torch.from_numpy(v).requires_grad_() for v in arrays]
    y, _ = mamba_scan(*ts)
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum(), ts)
    _close(y, j_y)
    for gt, jg in zip(grads, j_grads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def test_op_state_gradient_is_the_plain_versions():
    """With a state in and a loss on the final state too, the op's
    gradients (state0's included) are the plain version's VJP exactly."""
    arrays = [torch.from_numpy(v) for v in _inputs(6, 2, 9, 16, 8)]
    state0 = torch.from_numpy(
        np.random.RandomState(7).randn(2, 16, 8).astype(np.float32))
    gs = torch.from_numpy(
        np.random.RandomState(8).randn(2, 16, 8).astype(np.float32))
    outs = []
    for fn in (mamba_scan, mamba_scan_ref):
        ts = [t.clone().requires_grad_() for t in arrays + [state0]]
        y, st = fn(*ts)
        outs.append(torch.autograd.grad(y.sum() + (st * gs).sum(), ts))
    for mine, want in zip(*outs):
        torch.testing.assert_close(mine, want, rtol=0, atol=0)


def test_op_on_cpu_is_the_plain_version_and_never_the_kernel():
    arrays = [torch.from_numpy(v) for v in _inputs(5, 2, 9, 40, 16)]
    state0 = torch.ones(2, 40, 16)
    before = kernel.launches
    y, st = mamba_scan(*arrays, state0)
    assert kernel.launches == before
    want_y, want_s = mamba_scan_ref(*arrays, state0)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(st, want_s, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.mamba_scan_fwd(*arrays, state0)
    with pytest.raises(ValueError, match="no kernel for device"):
        mamba_scan(*(t.to("meta") for t in arrays))


@pytest.mark.parametrize("s", [1, 37, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_takes_the_models_strided_views(s, dtype):
    """The call ``models/mamba.py`` makes, which ``chip_smoke.py``'s scan
    rows draw too: x, D and one (B, S, dt_rank + 2N) projection in the
    compute type, B and C strided views of it, delta and A float32. The op
    gives the JAX oracle's y on the same values, and the same y and state
    as on contiguous float32 copies."""
    b, d, n, dtr = 2, 48, 16, 8
    x, delta, a, _, _, dd = _inputs(s + n, b, s, d, n)
    proj = np.random.RandomState(s).randn(b, s, dtr + 2 * n).astype(
        np.float32)
    if dtype == "bfloat16":
        x, dd, proj = (_bf16(v) for v in (x, dd, proj))
    tdt = getattr(torch, dtype)
    tproj = torch.from_numpy(proj).to(tdt)
    bm, cm = tproj[..., dtr:dtr + n], tproj[..., dtr + n:]
    assert not bm.is_contiguous() and bm.dtype == tdt
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(delta),
            torch.from_numpy(a), bm, cm, torch.from_numpy(dd).to(tdt))
    y, st = mamba_scan(*args)
    _close(y, jax_ref(*(jnp.asarray(v) for v in (
        x, delta, a, proj[..., dtr:dtr + n], proj[..., dtr + n:], dd))))
    want_y, want_s = mamba_scan_ref(*(t.float().contiguous() for t in args))
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(st, want_s, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the backward: the plain VJP the CPU runs and the card's kernel is held to


def test_bwd_plain_matches_jax_vjp():
    """``mamba_scan_bwd_plain`` (the VJP the CPU route takes, and the card's
    backward kernel's yardstick) with ``mamba_scan_bwd``'s arguments,
    against ``jax.vjp`` of the JAX op (Pallas kernel in interpret mode,
    VJP of its oracle) on the same cotangent: the gradients of x, delta, a,
    B, C and D at rtol 1e-4 / atol 1e-4, as
    ``test_op_gradients_match_jax_vjp``; no state in or out (the JAX op
    takes none)."""
    arrays = _inputs(9, 2, 64, 48, 16)
    gy = np.random.RandomState(10).randn(2, 64, 48).astype(np.float32)
    jarrays = [jnp.asarray(v) for v in arrays]
    _, vjp = jax.vjp(lambda *v: jax_op(*v, 48, 32), *jarrays)
    want = vjp(jnp.asarray(gy))
    got = mamba_scan_bwd_plain(*(torch.from_numpy(v) for v in arrays), None,
                               torch.from_numpy(gy))
    assert got[6] is None and len(got) == 7
    for g, jg in zip(got[:6], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_backward_on_cpu_is_the_plain_vjp_and_launches_nothing(dtype):
    """Through autograd on the CPU, with a state in, a state cotangent and
    the model's strided B and C views in the compute type, the op's
    gradients are ``mamba_scan_bwd_plain``'s to the bit, each in its
    input's type, and neither kernel launches; the backward wrapper refuses
    CPU tensors, and the route refuses a device with no kernel."""
    b, s, d, n, dtr = 2, 19, 40, 8, 4
    x, delta, a, _, _, dd = _inputs(11, b, s, d, n)
    r = np.random.RandomState(12)
    proj = r.randn(b, s, dtr + 2 * n).astype(np.float32)
    state0 = torch.from_numpy(r.randn(b, d, n).astype(np.float32))
    gy = torch.from_numpy(r.randn(b, s, d).astype(np.float32))
    gs = torch.from_numpy(r.randn(b, d, n).astype(np.float32))
    tdt = getattr(torch, dtype)

    def leaves():
        p = torch.from_numpy(proj).to(tdt).requires_grad_()
        ins = [torch.from_numpy(x).to(tdt), torch.from_numpy(delta),
               torch.from_numpy(a), None, None,
               torch.from_numpy(dd).to(tdt), state0.clone()]
        ins = [t if t is None else t.requires_grad_() for t in ins]
        ins[3], ins[4] = p[..., dtr:dtr + n], p[..., dtr + n:]
        return ins
    ins = leaves()
    before = (kernel.launches, kernel.bwd_launches)
    y, st = mamba_scan(*ins)
    grads = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), ins)
    assert (kernel.launches, kernel.bwd_launches) == before
    want = mamba_scan_bwd_plain(*leaves(), gy, gs)
    for g, w, t in zip(grads, want, ins):
        assert g.dtype == t.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    plain = [t.detach() for t in ins]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.mamba_scan_bwd(*plain, gy, gs)
    from repro_torch.kernels.mamba_scan import ops
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._backward(*(t.to("meta") for t in plain), gy.to("meta"), None)
