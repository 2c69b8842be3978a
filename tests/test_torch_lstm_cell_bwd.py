"""The LSTM cell's gradient in the port against the JAX package's, on the
CPU: the plain backward of one timestep (``lstm_cell_bwd_plain``, what the
backward kernel is held to on the card) against ``jax.vjp`` of the JAX
cell, and the whole-sequence autograd (``LSTMSequenceFunction``, whose CPU
route runs that plain backward a step) against ``jax.vjp`` of the JAX
model's LSTM. Inputs and cotangents are made with numpy from a seed.

fp32 tolerance 1e-5 (absolute and relative): both sides compute in fp32
and differ in the order of their sums (over D+H for dxh, over the batch
and the steps for dW and db).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell.ref import lstm_cell_ref as jax_lstm_cell_ref
from repro.models.rnn import run_lstm
from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ops import (
    LSTMSequenceFunction,
    lstm_cell_bwd_flops,
    lstm_cell_flops,
    lstm_sequence,
)
from repro_torch.kernels.lstm_cell.ref import (
    lstm_cell_bwd_plain,
    lstm_cell_fwd_plain,
)
from repro_torch.models.convert import (
    lstm_bias_to_kernel,
    lstm_weight_to_kernel,
)

TOL = 1e-5
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _cell_inputs(seed, b, d, h, dtype=np.float32):
    r = np.random.RandomState(seed)
    k = d + h
    return (r.randn(b, k).astype(dtype),
            (r.randn(k, h, 4) / np.sqrt(k)).astype(dtype),
            (r.randn(h, 4) * 0.5).astype(dtype),
            r.randn(b, h).astype(dtype),
            r.randn(b, h).astype(dtype),             # h_new's cotangent
            r.randn(b, h).astype(dtype))             # c_new's


@pytest.mark.parametrize("b,d,h", [
    (16, 32, 16), (4, 96, 128), (3, 7, 5), (5, 77, 200),   # last two ragged
])
def test_cell_backward_matches_jax_vjp(b, d, h):
    """dxh and dc_prev from the plain backward, dW = xh^T dz and db = the
    sum of dz's rows, against ``jax.vjp`` of the JAX cell at random
    cotangents."""
    xh, w, bias, c, dh, dc = _cell_inputs(b, b, d, h)
    _, vjp = jax.vjp(jax_lstm_cell_ref, *map(jnp.asarray, (xh, w, bias, c)))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dh), jnp.asarray(dc)))]

    t = [torch.from_numpy(a) for a in (xh, w, bias, c, dh, dc)]
    z = lstm_cell_fwd_plain(*t[:4])[2]
    dz, dxh, dc_prev = lstm_cell_bwd_plain(z, t[3], t[1], t[4], t[5])
    assert (dz.shape, dxh.shape, dc_prev.shape) == ((b, h, 4), (b, d + h),
                                                    (b, h))
    got = [dxh, (t[0].T @ dz.reshape(b, 4 * h)).reshape(d + h, h, 4),
           dz.sum(0), dc_prev]
    for name, g, w_ in zip(("dxh", "dw", "db", "dc_prev"), got,
                           (want[0], want[1], want[2], want[3])):
        np.testing.assert_allclose(g.numpy(), w_, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_cell_backward_adds_the_second_share_of_dh():
    """``dh_up`` is a second share of h_new's cotangent: the same as
    passing the sum, to the rounding of one addition."""
    xh, w, bias, c, dh, dc = map(torch.from_numpy, _cell_inputs(7, 4, 6, 9))
    z = lstm_cell_fwd_plain(xh, w, bias, c)[2]
    up = torch.from_numpy(np.random.RandomState(8).randn(4, 9)
                          .astype(np.float32))
    split = lstm_cell_bwd_plain(z, c, w, dh, dc, up)
    whole = lstm_cell_bwd_plain(z, c, w, dh + up, dc)
    for a, b_ in zip(split, whole):
        assert torch.equal(a, b_)


def _seq_inputs(seed, bsz, s, d, h, dtype=np.float32):
    r = np.random.RandomState(seed)
    return (r.randn(bsz, s, d).astype(dtype),
            (r.randn(d + h, 4 * h) / np.sqrt(d + h)).astype(dtype),
            (r.randn(4 * h) * 0.1).astype(dtype),
            r.randn(bsz, s, h).astype(dtype))        # the layer's cotangent


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bsz,s,d,h", [(3, 7, 10, 12), (2, 1, 5, 4),
                                       (4, 13, 6, 17)])
def test_sequence_gradient_matches_jax_vjp_of_run_lstm(reverse, bsz, s, d,
                                                       h):
    """The CPU sequence Function's hs and its gradients of xs, w and b
    against ``jax.vjp`` of the JAX model's LSTM (zero initial state, as
    the model runs it), weights through the layout adapters."""
    xs, w, b, g = _seq_inputs(s, bsz, s, d, h)
    hs_j, vjp = jax.vjp(lambda p, x: run_lstm(p, x, reverse=reverse),
                        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                        jnp.asarray(xs))
    dp, dxs = vjp(jnp.asarray(g))

    ts = [torch.from_numpy(xs).requires_grad_(), torch.zeros(bsz, h),
          torch.zeros(bsz, h),
          torch.from_numpy(lstm_weight_to_kernel(w)).requires_grad_(),
          torch.from_numpy(lstm_bias_to_kernel(b)).requires_grad_()]
    hs = lstm_sequence(*ts, reverse=reverse)
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(hs_j),
                               rtol=TOL, atol=TOL)
    gx, gw, gb = torch.autograd.grad(hs, (ts[0], ts[3], ts[4]),
                                     torch.from_numpy(g))
    for name, got, want in (
            ("dxs", gx, np.asarray(dxs)),
            ("dw", gw, lstm_weight_to_kernel(np.asarray(dp["w"]))),
            ("db", gb, lstm_bias_to_kernel(np.asarray(dp["b"])))):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_gradcheck_float64(reverse):
    """Every input's gradient, h0 and c0 among them, by finite
    differences in float64."""
    r = np.random.RandomState(11)
    bsz, s, d, h = 2, 4, 3, 3
    arrays = (r.randn(bsz, s, d), r.randn(bsz, h), r.randn(bsz, h),
              r.randn(d + h, h, 4) * 0.5, r.randn(h, 4) * 0.5)
    ts = tuple(torch.from_numpy(a).requires_grad_() for a in arrays)
    assert torch.autograd.gradcheck(
        lambda *t: LSTMSequenceFunction.apply(*t, reverse, True), ts)


def test_sequence_saves_nothing_without_a_gradient():
    """Under ``no_grad`` (or with no input needing one) the forward writes
    no z and keeps no buffers; the result is the same."""
    xs, w, b, _ = _seq_inputs(3, 2, 5, 4, 6)
    args = (torch.from_numpy(xs), torch.zeros(2, 6), torch.zeros(2, 6),
            torch.from_numpy(lstm_weight_to_kernel(w)).requires_grad_(),
            torch.from_numpy(lstm_bias_to_kernel(b)))
    with torch.no_grad():
        free = lstm_sequence(*args)
    assert free.grad_fn is None
    tracked = lstm_sequence(*args)
    assert tracked.grad_fn is not None
    assert torch.equal(free, tracked.detach())


def test_sequence_raises_on_a_device_without_kernel():
    args = [torch.empty(s, device="meta")
            for s in ((2, 3, 5), (2, 4), (2, 4), (9, 4, 4), (4, 4))]
    with pytest.raises(ValueError, match="no kernel"):
        lstm_sequence(*args)


def test_backward_wrapper_refuses_cpu_tensors():
    before = kernel.bwd_launches
    xh, w, bias, c, dh, dc = map(torch.from_numpy, _cell_inputs(5, 2, 3, 4))
    z = lstm_cell_fwd_plain(xh, w, bias, c)[2]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.lstm_cell_bwd(z, c, w, dh, dc)
    assert kernel.bwd_launches == before


# ---------------------------------------------------------------------------
# the ops under a fake-tensor trace and the operation counters


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    return cs


def test_backward_op_fake_shapes_and_flops(monkeypatch, chip_smoke):
    """The backward op on fake CUDA tensors: (dz, dxh, dc_prev) in their
    shapes, one fake call, no launch; ``FlopCounterMode`` counts
    ``lstm_cell_bwd_flops``, the operations ``chip_smoke.py``'s bound
    takes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    bsz, k, h = 16, 2048, 1024
    kernel.bwd_fake_calls = 0
    launches = kernel.bwd_launches
    with FakeTensorMode():
        z = torch.empty((bsz, h, 4), device="cuda")
        c, dh, dc = (torch.empty((bsz, h), device="cuda") for _ in range(3))
        w = torch.empty((k, h, 4), device="cuda")
        with FlopCounterMode(display=False) as counter:
            dz, dxh, dc_prev = torch.ops.repro_torch.lstm_cell_bwd(
                z, c, w, dh, dc, None)
    assert [tuple(t.shape) for t in (dz, dxh, dc_prev)] == [
        (bsz, h, 4), (bsz, k), (bsz, h)]
    assert all(t.device.type == "cuda" for t in (dz, dxh, dc_prev))
    assert (kernel.bwd_fake_calls, kernel.bwd_launches) == (1, launches)
    assert counter.get_total_flops() == lstm_cell_bwd_flops(bsz, k, h) \
        == 2 * bsz * k * 4 * h
    monkeypatch.setattr(chip_smoke, "HBM_BYTES_PER_S", float("inf"))
    ms, by = chip_smoke.cell_bwd_bound_ms(bsz, k, h)
    assert by == "operations"
    assert ms * 1e-3 * chip_smoke.FP32_FLOPS_PER_S == pytest.approx(
        lstm_cell_bwd_flops(bsz, k, h), rel=1e-12)


class _Ctx:
    """What an autograd.Function's forward and backward use of ``ctx``."""

    needs_input_grad = (True,) * 5 + (False, False)

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_follows_a_fake_trace(monkeypatch, reverse):
    """``LSTMSequenceFunction``'s forward and backward, called as autograd
    calls them, on fake tensors that answer ``is_cuda`` as the card's do (a
    fake CUDA tensor cannot be viewed in a CPU-only torch): S forward and S
    backward fake calls, no launch, every gradient in its input's shape,
    and the operations of S cells each way plus one dW product over the
    S·B rows."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.perfmodel.counters import DeviceFlops

    monkeypatch.setattr(FakeTensor, "is_cuda", property(lambda self: True))
    bsz, s, d, h = 16, 6, 1024, 512
    k = d + h
    kernel.fake_calls = kernel.bwd_fake_calls = 0
    launches = kernel.launches + kernel.bwd_launches
    shapes = ((bsz, s, d), (bsz, h), (bsz, h), (k, h, 4), (h, 4))
    with FakeTensorMode():
        made = [torch.empty(sh) for sh in shapes]
        with DeviceFlops() as flops:
            ctx = _Ctx()
            hs = LSTMSequenceFunction.forward(ctx, *made, reverse, True)
            grads = LSTMSequenceFunction.backward(ctx, torch.empty_like(hs))
    assert tuple(hs.shape) == (bsz, s, h)
    assert [tuple(g.shape) for g in grads[:5]] == list(shapes)
    assert grads[5:] == (None, None)
    assert (kernel.fake_calls, kernel.bwd_fake_calls) == (s, s)
    assert kernel.launches + kernel.bwd_launches == launches
    assert flops.flops == s * (lstm_cell_flops(bsz, k, h)
                               + lstm_cell_bwd_flops(bsz, k, h)) \
        + 2 * s * bsz * k * 4 * h
