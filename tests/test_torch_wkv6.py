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
from repro_torch.kernels.rwkv6_wkv.ops import wkv6
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
