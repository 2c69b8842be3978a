"""The port's WKV6 (plain version, autograd op, the model's chunked and
sequential forms) against the JAX package's Pallas kernel (interpret mode),
its oracle and its model paths, on the CPU, with inputs made from a numpy
seed. Tolerance 5e-4, the JAX package's kernel test's: float32 sums taken
in another order, over recurrences of up to 256 steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.kernel import wkv6_fwd as jax_kernel
from repro.kernels.rwkv6_wkv.ops import wkv6 as jax_op
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_ref
from repro.models import rwkv as jrw
from repro_torch.kernels.rwkv6_wkv import kernel
from repro_torch.kernels.rwkv6_wkv.ops import wkv6, wkv6_bwd_plain
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref
from repro_torch.models import rwkv as trw

TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(seed, lead, dh, u_lead):
    """r, k, v ~ N(0, 1) and lw = -exp(clip(N(0, 1), -8, 0)) in [-1, 0),
    as the JAX kernel test draws them, shaped ``lead + (dh,)``; u ~ N(0, 1)
    shaped ``u_lead + (dh,)``."""
    r = np.random.RandomState(seed)
    shape = tuple(lead) + (dh,)
    arrays = [r.randn(*shape) for _ in range(3)]
    arrays.append(-np.exp(np.clip(r.randn(*shape), -8, 0)))
    arrays.append(r.randn(*(tuple(u_lead) + (dh,))))
    return [a.astype(np.float32) for a in arrays]


def _close(mine, want):
    np.testing.assert_allclose(mine.detach().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("bh,s,dh,chunk", [
    (2, 128, 64, 32), (4, 256, 64, 64), (2, 64, 32, 64), (3, 192, 64, 64),
])
def test_ref_matches_jax_kernel_and_oracle(bh, s, dh, chunk):
    """The grid of the JAX package's kernel test."""
    arrays = _inputs(bh + s, (bh, s), dh, (bh,))
    y, st = wkv6_ref(*(torch.from_numpy(a) for a in arrays))
    assert y.shape == (bh, s, dh) and st.shape == (bh, dh, dh)
    jarrays = [jnp.asarray(a) for a in arrays]
    _close(y, jax_kernel(*jarrays, chunk=chunk, interpret=True))
    _close(y, jax_ref(*jarrays))


@pytest.mark.parametrize("form", ["op", "model"])
@pytest.mark.parametrize("b,s,h,dh,chunk", [
    (2, 128, 2, 32, 32),                   # chunked, two chunks
    (2, 192, 3, 64, 64),                   # chunked at the model's chunk
    (2, 100, 3, 64, 0),                    # ragged: sequential
    (3, 1, 2, 64, 0),                      # a decode step
    (1, 64, 4, 32, 0),
])
def test_matches_jax_model_paths_with_state(form, b, s, h, dh, chunk):
    """y and the final state from a non-zero state0, against the JAX
    model's ``wkv6_chunked`` (chunk > 0) or ``wkv6_sequential``; ``op`` is
    the port's autograd op (the plain version here), ``model`` the port's
    own form of the same path."""
    arrays = _inputs(s + dh, (b, s, h), dh, (h,))
    state0 = np.random.RandomState(s).randn(b, h, dh, dh).astype(np.float32)
    jarrays = [jnp.asarray(a) for a in arrays + [state0]]
    if chunk:
        jy, js = jrw.wkv6_chunked(*jarrays, chunk=chunk)
    else:
        jy, js = jrw.wkv6_sequential(*jarrays)
    targs = [torch.from_numpy(a) for a in arrays + [state0]]
    if form == "op":
        y, st = wkv6(*targs)
    elif chunk:
        y, st = trw.wkv6_chunked(*targs, chunk=chunk)
    else:
        y, st = trw.wkv6_sequential(*targs)
    assert y.shape == (b, s, h, dh) and st.shape == (b, h, dh, dh)
    _close(y, jy)
    _close(st, js)


def test_op_gradients_match_jax_vjp():
    """Loss sum(y * c), c fixed, through the JAX op (Pallas kernel in
    interpret mode, VJP of its oracle) and the port's op (VJP of its plain
    version): forward at 5e-4, gradients of r, k, v, lw and u at rtol 1e-4
    / atol 1e-4. A loss linear in y keeps the forwards' difference out of
    the cotangent, so the gradients compare the two VJPs alone."""
    arrays = _inputs(3, (1, 64, 2), 32, (2,))
    c = np.random.RandomState(4).randn(1, 64, 2, 32).astype(np.float32)
    jarrays = [jnp.asarray(a) for a in arrays]
    j_y = jax_op(*jarrays, 32)
    j_grads = jax.grad(lambda *a: jnp.sum(jax_op(*a, 32) * c),
                       argnums=(0, 1, 2, 3, 4))(*jarrays)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, _ = wkv6(*ts)
    grads = torch.autograd.grad((y * torch.from_numpy(c)).sum(), ts)
    _close(y, j_y)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def test_op_on_cpu_is_the_plain_version_and_never_the_kernel():
    arrays = [torch.from_numpy(a) for a in _inputs(5, (2, 9, 3), 64, (3,))]
    state0 = torch.ones(2, 3, 64, 64)
    before = kernel.launches
    y, st = wkv6(*arrays, state0)
    assert kernel.launches == before
    fold = [t.transpose(1, 2).reshape(6, 9, 64) for t in arrays[:4]]
    want_y, want_s = wkv6_ref(*fold, arrays[4].repeat(2, 1),
                              state0.reshape(6, 64, 64))
    torch.testing.assert_close(y, want_y.reshape(2, 3, 9, 64).transpose(1, 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(st, want_s.reshape(2, 3, 64, 64), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.wkv6_fwd(*arrays, state0)
    with pytest.raises(ValueError, match="no kernel for device"):
        wkv6(*(t.to("meta") for t in arrays))


LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: 10 explicit
    mantissa bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b with each operand rounded as the kernel's mma.sync sees it:
    one TF32 pass, or the 3xTF32 split (hi + lo, each rounded to TF32;
    lo hi + hi lo + hi hi), summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def wkv6_chunked_tf32(r, k, v, lw, u, passes=3, chunk=32):
    """The CUDA kernel's chunked form in float32 with its operand rounding,
    folded layout (BH, S, dh), zero state in: per chunk (the kernel's 32
    steps by default), cs = cumsum(lw) in log2 units, r~ = r 2^(cs_{i-1}),
    k~ = k 2^(-cs), att = r~ k~^T strictly lower with the bonus
    r_i . (u k_i) on the diagonal, y = att v + r~ S and
    S <- diag(2^total) (S + k~^T v), each product as ``_mm_tf32`` from zero
    and added to S in float32, 2^total rounded from float64. A ragged tail
    is zero-padded with lw = 0."""
    bh, s, dh = r.shape
    pad = (-s) % chunk
    r, k, v, lw = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (r, k, v, lw))
    st = torch.zeros(bh, dh, dh)
    mask = torch.tril(torch.ones(chunk, chunk), -1).bool()
    eye = torch.eye(chunk).bool()
    ys = []
    for c0 in range(0, s + pad, chunk):
        rc, kc, vc, wc = (t[:, c0:c0 + chunk] for t in (r, k, v, lw))
        cs = torch.cumsum(wc * LOG2E, dim=1)
        prev = torch.nn.functional.pad(cs, (0, 0, 1, 0))[:, :-1]
        rt, kt = rc * torch.exp2(prev), kc * torch.exp2(-cs)
        bonus = (rc * u[:, None] * kc).sum(-1)
        att = _mm_tf32(rt, kt.transpose(1, 2), passes)
        att = torch.where(mask, att, torch.zeros(()))
        att = torch.where(eye, bonus[:, :, None], att)
        ys.append(_mm_tf32(att, vc, passes) + _mm_tf32(rt, st, passes))
        etot = torch.exp2(cs[:, -1].double()).float()
        st = etot[:, :, None] * (st + _mm_tf32(kt.transpose(1, 2), vc,
                                               passes))
    return torch.cat(ys, dim=1)[:, :s], st


def _oracle64(r, k, v, lw, u, state0=None):
    """The sequential recurrence in float64, folded layout, from state0
    (zeros when None): the reference where fp32's own rounding is the
    larger error (see below)."""
    r, k, v, lw, u = (t.double() for t in (r, k, v, lw, u))
    w = torch.exp(lw)
    bh, s, dh = r.shape
    st = (torch.zeros(bh, dh, dh, dtype=torch.float64) if state0 is None
          else state0.double())
    ys = []
    for t in range(s):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bk,bkv->bv", rt, st)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        st = w[:, t, :, None] * st + kt[:, :, None] * vt[:, None, :]
    return torch.stack(ys, dim=1), st


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("lw_kind", ["draw", "-1", "-1e-6"])
def test_kernel_tf32x3_rounding_holds_the_tolerance(lw_kind, chunk):
    """The design's precision argument on the CPU: the chunked form with
    the kernel's 3xTF32 operand rounding, at rwkv6-3b's head width
    (dh = 64) over S = 1536, with the kernel's 32-step chunk and the Pallas
    kernel's 64, within 5e-4 (y and the final state)
    of the sequential oracle ``wkv6_ref`` for the usual lw draw and for
    lw = -1, the clamp's lower end. At its upper end, lw = -1e-6, the
    fp32 oracle itself is further than that from the float64 recurrence
    (its rounded decay exp(-1e-6) compounds over 1536 steps: 1.8e-2 in y
    at |y| ~ 1e3), so there the reference is the float64 recurrence."""
    r_, k_, v_, lw_, u_ = _inputs(11, (2, 1536), 64, (2,))
    if lw_kind != "draw":
        lw_ = np.full_like(lw_, float(lw_kind))
    r, k, v, lw, u = (torch.from_numpy(a) for a in (r_, k_, v_, lw_, u_))
    if lw_kind == "-1e-6":
        y_want, s_want = (t.float() for t in _oracle64(r, k, v, lw, u))
    else:
        y_want, s_want = wkv6_ref(r, k, v, lw, u)
    y, st = wkv6_chunked_tf32(r, k, v, lw, u, passes=3, chunk=chunk)
    torch.testing.assert_close(y, y_want, **TOL)
    torch.testing.assert_close(st, s_want, **TOL)


def test_one_tf32_pass_misses_the_tolerance():
    """Why the kernel splits its operands: one TF32 pass (10 mantissa
    bits, unit roundoff 4.9e-4) in the same chunked form is 4.4e-2 from the
    oracle in y at this draw, far outside 5e-4, where 3xTF32 is within it
    (above)."""
    arrays = [torch.from_numpy(a) for a in _inputs(11, (2, 1536), 64, (2,))]
    y_want, _ = wkv6_ref(*arrays)
    y1, _ = wkv6_chunked_tf32(*arrays, passes=1)
    assert (y1 - y_want).abs().max().item() > 40 * 5e-4


# ---------------------------------------------------------------------------
# the backward: the plain VJP the CPU runs and the card's kernel is held to


def _cotangents(seed, b, s, h, dh):
    r = np.random.RandomState(seed)
    return (r.randn(b, s, h, dh).astype(np.float32),
            r.randn(b, h, dh, dh).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,h,dh", [(2, 40, 2, 32), (1, 33, 3, 64)])
def test_bwd_plain_matches_jax_vjp_of_the_sequential_model(b, s, h, dh,
                                                           with_state):
    """``wkv6_bwd_plain`` (the VJP the CPU route takes, and the card's
    backward kernel's yardstick) against ``jax.vjp`` of the JAX model's
    ``wkv6_sequential``, which takes and returns a state: every gradient,
    dstate0 and the final state's cotangent included, at rtol 1e-4 / atol
    1e-4. Without a state in, the JAX side starts from zeros and takes no
    state cotangent."""
    arrays = _inputs(s + dh, (b, s, h), dh, (h,))
    state0 = np.random.RandomState(s).randn(b, h, dh, dh).astype(np.float32)
    gy, gs = _cotangents(s + 1, b, s, h, dh)
    if not with_state:
        state0, gs = np.zeros_like(state0), np.zeros_like(gs)
    jarrays = [jnp.asarray(a) for a in arrays + [state0]]
    _, vjp = jax.vjp(jrw.wkv6_sequential, *jarrays)
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    ts = [torch.from_numpy(a) for a in arrays]
    got = wkv6_bwd_plain(*ts, torch.from_numpy(state0) if with_state
                         else None, torch.from_numpy(gy),
                         torch.from_numpy(gs) if with_state else None)
    assert (got[5] is None) == (not with_state)
    for g, jg in zip(got, want[:len(got)]):
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                                       rtol=1e-4, atol=1e-4)


def test_op_backward_on_cpu_is_the_plain_vjp_and_launches_nothing():
    """Through autograd on the CPU the op's gradients, state0's included,
    are ``wkv6_bwd_plain``'s to the bit, and neither kernel launches; the
    backward wrapper refuses CPU tensors, and the route refuses a device
    with no kernel."""
    b, s, h, dh = 2, 9, 3, 64
    arrays = [torch.from_numpy(a) for a in _inputs(5, (b, s, h), dh, (h,))]
    state0 = torch.from_numpy(
        np.random.RandomState(6).randn(b, h, dh, dh).astype(np.float32))
    gy, gs = (torch.from_numpy(a) for a in _cotangents(7, b, s, h, dh))
    before = (kernel.launches, kernel.bwd_launches)
    ts = [t.clone().requires_grad_() for t in arrays + [state0]]
    y, st = wkv6(*ts)
    grads = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), ts)
    assert (kernel.launches, kernel.bwd_launches) == before
    want = wkv6_bwd_plain(*arrays, state0, gy, gs)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.wkv6_bwd(*arrays, state0, gy, gs)
    from repro_torch.kernels.rwkv6_wkv import ops
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._backward(*(t.to("meta") for t in arrays), None, gy.to("meta"),
                      None)


def _dlw_identity(r, k, v, lw, u, state0, gy, gs):
    """dlw as the backward kernel takes it (``csrc/wkv6_bwd.cu``), folded
    layout (BH, S, dh): the reverse pass's k_s (.) dk^S_s and the forward
    pass's r_t (.) dr^S_t in float32, their running difference
    sum_{s<t} k (.) dk^S - sum_{tau<=t} r (.) dr^S in float64, started at
    state0's term rowsum(state0 (.) G_0)."""
    w = torch.exp(lw)
    s = r.shape[1]
    grad = gs.clone()
    kdk = [None] * s
    for t in reversed(range(s)):
        kdk[t] = k[:, t] * torch.einsum("bij,bj->bi", grad, v[:, t])
        grad = w[:, t, :, None] * grad + r[:, t, :, None] * gy[:, t, None, :]
    diff = (state0 * grad).sum(-1).double()
    st, out = state0.clone(), []
    for t in range(s):
        rdr = r[:, t] * torch.einsum("bij,bj->bi", st, gy[:, t])
        diff = diff - rdr.double()
        out.append(diff.float())
        diff = diff + kdk[t].double()
        st = w[:, t, :, None] * st + k[:, t, :, None] * v[:, t, None, :]
    return torch.stack(out, dim=1)


@pytest.fixture
def one_thread():
    """4096 steps of microsecond ops: threads only contend (the suite runs
    several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lw_kind", ["draw", "-1"])
def test_dlw_identity_holds_at_4096_steps(one_thread, lw_kind):
    """The backward kernel's state-free dlw over S = 4096 (two heads of 64,
    a state in and a state cotangent) against the float64 VJP of the plain
    recurrence: within 1e-4 of max |dlw|, five times inside the card
    tests' 5e-4. lw = -1, the clamp's lower end, is where the identity's
    two sums are largest beside dlw itself. Measured: 2.9e-6 (draw) and
    6.1e-6 (-1) of max |dlw|, where the float32 plain VJP is 1.2e-7 and
    1.5e-7 away and two float32 running sums gave 3.4e-5 and 6.7e-5."""
    bh, s, dh = 2, 4096, 64
    arrays = _inputs(17, (bh, s), dh, (bh,))
    if lw_kind != "draw":
        arrays[3] = np.full_like(arrays[3], float(lw_kind))
    r = np.random.RandomState(18)
    state0 = r.randn(bh, dh, dh).astype(np.float32)
    gy = r.randn(bh, s, dh).astype(np.float32)
    gs = r.randn(bh, dh, dh).astype(np.float32)
    ins = [torch.from_numpy(a).double().requires_grad_()
           for a in arrays + [state0]]
    y, st = _oracle64(*ins)
    want = torch.autograd.grad(
        (y * torch.from_numpy(gy).double()).sum()
        + (st * torch.from_numpy(gs).double()).sum(), ins[3])[0]
    got = _dlw_identity(*(torch.from_numpy(a) for a in arrays + [state0]),
                        torch.from_numpy(gy), torch.from_numpy(gs))
    gap = (got.double() - want).abs().max() / want.abs().max()
    assert gap.item() <= 1e-4, gap.item()
