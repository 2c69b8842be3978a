"""The LSTM's gradient in the port against the JAX package's, on the CPU:
the plain backward of one timestep (``lstm_cell_bwd_plain``) against
``jax.vjp`` of the JAX cell; the plain walk of a layer
(``lstm_seq_bwd_plain``, what the walk kernel is held to on the card) with
the products after it against ``jax.vjp`` of a ``lax.scan`` over the JAX
cell with a state in; the walk kernel's partition emulated in torch
against the plain walk; and the whole-sequence autograd
(``LSTMSequenceFunction``, whose CPU route runs the plain walk) against
``jax.vjp`` of the JAX model's LSTM. Inputs and cotangents are made with
numpy from a seed.

fp32 tolerance 1e-5 (absolute and relative): both sides compute in fp32
and differ in the order of their sums (over D+H for dxh, over 4H for a
step's carry, over the batch and the steps for dW and db).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.lstm_cell.ref import lstm_cell_ref as jax_lstm_cell_ref
from repro.models.rnn import lstm_cell as jax_model_cell
from repro.models.rnn import run_lstm
from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ops import (
    LSTMSequenceFunction,
    lstm_cell_flops,
    lstm_seq_bwd_flops,
    lstm_sequence,
)
from repro_torch.kernels.lstm_cell.ref import (
    _gate_bwd,
    lstm_cell_bwd_plain,
    lstm_cell_fwd_plain,
    lstm_seq_bwd_plain,
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


def _forward_walk(xs, h0, c0, w, b, reverse):
    """The plain forward of a layer in step order: (xh (S, B, D+H), zs (S,
    B, H, 4), cs (S+1, B, H)), as ``LSTMSequenceFunction`` saves them."""
    s = xs.shape[1]
    steps = range(s - 1, -1, -1) if reverse else range(s)
    h, c = h0, c0
    xh, zs, cs = [], [], [c0]
    for t in steps:
        xh.append(torch.cat([xs[:, t], h], dim=-1))
        h, c, z = lstm_cell_fwd_plain(xh[-1], w, b, c)
        zs.append(z)
        cs.append(c)
    return torch.stack(xh), torch.stack(zs), torch.stack(cs)


def _jax_layer(p, xs, h0, c0, reverse):
    """hs (B, S, H) and the last (h, c) of a ``lax.scan`` over the JAX
    model's cell from (h0, c0): ``run_lstm`` with a state in."""
    carry, hs = jax.lax.scan(lambda cr, x: jax_model_cell(p, cr, x),
                             (h0, c0), jnp.moveaxis(xs, 1, 0),
                             reverse=reverse)
    return jnp.moveaxis(hs, 0, 1), carry[1]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bsz,s,d,h", [(3, 7, 10, 12), (2, 9, 5, 7),
                                       (5, 11, 13, 6)])    # last two ragged
def test_walk_matches_jax_vjp_with_a_state(reverse, bsz, s, d, h):
    """``lstm_seq_bwd_plain`` and the products after it (dX = dZ W_x^T put
    back in time order, dW = XH^T dZ, db) against ``jax.vjp`` of a scan
    over the JAX cell from a random (h0, c0), with cotangents of hs and of
    the last c: every gradient, h0's and c0's among them, at 1e-5."""
    r = np.random.RandomState(20 + s)
    xs, w, b, gy = _seq_inputs(s, bsz, s, d, h)
    h0, c0, dc_last = (r.randn(bsz, h).astype(np.float32) for _ in range(3))
    out, vjp = jax.vjp(
        lambda p, x, a, c: _jax_layer(p, x, a, c, reverse),
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, *map(jnp.asarray,
                                                        (xs, h0, c0)))
    dp, dxs_j, dh0_j, dc0_j = vjp((jnp.asarray(gy), jnp.asarray(dc_last)))

    wk = torch.from_numpy(lstm_weight_to_kernel(w))
    bk = torch.from_numpy(lstm_bias_to_kernel(b))
    xh, zs, cs = _forward_walk(torch.from_numpy(xs), torch.from_numpy(h0),
                               torch.from_numpy(c0), wk, bk, reverse)
    g = torch.from_numpy(gy).transpose(0, 1)
    g = (g.flip(0) if reverse else g).contiguous()
    dzs, dh0, dc0 = lstm_seq_bwd_plain(zs, cs, wk, g,
                                       torch.from_numpy(dc_last))
    assert (dzs.shape, dh0.shape, dc0.shape) == ((s, bsz, h, 4), (bsz, h),
                                                 (bsz, h))
    dz2 = dzs.reshape(s * bsz, 4 * h)
    dx = (dz2 @ wk[:d].reshape(d, 4 * h).T).reshape(s, bsz, d)
    dxs = (dx.flip(0) if reverse else dx).transpose(0, 1)
    dw = (xh.reshape(s * bsz, d + h).T @ dz2).reshape(d + h, h, 4)
    for name, got, want in (
            ("dxs", dxs, np.asarray(dxs_j)), ("dh0", dh0, np.asarray(dh0_j)),
            ("dc0", dc0, np.asarray(dc0_j)),
            ("dw", dw, lstm_weight_to_kernel(np.asarray(dp["w"]))),
            ("db", dz2.sum(0).reshape(h, 4),
             lstm_bias_to_kernel(np.asarray(dp["b"])))):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)


def emulate_walk(zs, cs, w, g, sms, dc=None):
    """The walk kernel's partition in torch, fp32: blocks of
    ``kernel.walk_units(H, sms)`` units; each step the gate math of every
    (b, unit), then each block's carries from the whole of dz_t, thread tg
    of a group of ``kernel.WALK_GROUP`` chaining its units tg, tg + 128,
    ... gate by gate, its warp's 32 lanes summed by the butterfly (pairs
    16, 8, 4, 2, 1 apart), the group's warps summed in order."""
    s, b, h, _ = zs.shape
    grp = kernel.WALK_GROUP
    units = kernel.walk_units(h, sms)
    pad = -h % grp
    per = (h + pad) // grp
    wh = F.pad(w[w.shape[0] - h:], (0, 0, 0, pad)).reshape(h, per, grp, 4)
    carry = torch.zeros(b, h)
    dc = torch.zeros(b, h) if dc is None else dc
    dzs = torch.empty_like(zs)
    for t in range(s - 1, -1, -1):
        dzs[t], dc = _gate_bwd(zs[t], cs[t], carry + g[t], dc)
        dz = F.pad(dzs[t], (0, 0, 0, pad)).reshape(b, per, grp, 4)
        new = torch.empty(b, h)
        for u0 in range(0, h, units):
            rows = wh[u0:u0 + units]
            part = torch.zeros(b, rows.shape[0], grp)
            for i in range(per):
                for q in range(4):
                    part = part + dz[:, None, i, :, q] * rows[None, :, i, :, q]
            lanes = part.reshape(b, rows.shape[0], grp // 32, 32)
            while lanes.shape[-1] > 1:
                half = lanes.shape[-1] // 2
                lanes = lanes[..., :half] + lanes[..., half:]
            warps = lanes[..., 0]
            total = warps[..., 0]
            for q in range(1, grp // 32):
                total = total + warps[..., q]
            new[:, u0:u0 + units] = total
        carry = new
    return dzs, carry, dc


@pytest.mark.parametrize("bsz,s,h,sms", [
    (16, 3, 1024, 132),    # GNMT's width: 8 units a block, 128 blocks
    (16, 3, 512, 132),     # enc_bi's: 4 units a block
    (5, 4, 200, 132),      # ragged: 2 units a block, H not a multiple of 128
    (3, 3, 300, 16),       # 19 units a block: W_h read from device memory
    (1, 1, 40, 132),       # one step, one row
])
def test_walk_emulation_matches_plain_walk(bsz, s, h, sms):
    """The kernel's partition and fixed summation order, emulated, against
    the plain walk within fp32 noise (1e-5 of each output's max)."""
    r = np.random.RandomState(h + s)
    d = 24
    zs = torch.from_numpy(r.randn(s, bsz, h, 4).astype(np.float32))
    cs = torch.from_numpy(r.randn(s + 1, bsz, h).astype(np.float32))
    w = torch.from_numpy((r.randn(d + h, h, 4) / np.sqrt(d + h))
                         .astype(np.float32))
    g = torch.from_numpy(r.randn(s, bsz, h).astype(np.float32))
    dc = torch.from_numpy(r.randn(bsz, h).astype(np.float32))
    units = kernel.walk_units(h, sms)
    assert -(-h // units) <= sms and (units - 1) * sms < h
    for got, want in zip(emulate_walk(zs, cs, w, g, sms, dc),
                         lstm_seq_bwd_plain(zs, cs, w, g, dc)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_sequence_raises_on_a_device_without_kernel():
    args = [torch.empty(s, device="meta")
            for s in ((2, 3, 5), (2, 4), (2, 4), (9, 4, 4), (4, 4))]
    with pytest.raises(ValueError, match="no kernel"):
        lstm_sequence(*args)


def _walk_args(s, bsz, d, h, seed=5):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(r.randn(*shape).astype(np.float32))
            for shape in ((s, bsz, h, 4), (s + 1, bsz, h), (d + h, h, 4),
                          (s, bsz, h), (bsz, h))]


def test_backward_wrapper_refuses_cpu_tensors():
    before = kernel.bwd_launches
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.lstm_seq_bwd(*_walk_args(3, 2, 3, 4))
    assert kernel.bwd_launches == before


def test_backward_wrapper_refuses_a_wrong_dtype_or_layout(monkeypatch):
    """On tensors that answer ``is_cuda`` as the card's do (fakes: a CPU-only
    torch has no CUDA tensor), the wrapper refuses float64, a transposed
    input and a wrong shape before it launches anything."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    monkeypatch.setattr(FakeTensor, "is_cuda", property(lambda self: True))
    before = kernel.bwd_launches
    with FakeTensorMode() as mode:
        zs, cs, w, g, dc = (mode.from_tensor(t)
                            for t in _walk_args(3, 4, 5, 6))
        with pytest.raises(ValueError, match="float32"):
            kernel.lstm_seq_bwd(zs.double(), cs, w, g)
        with pytest.raises(ValueError, match="contiguous"):
            kernel.lstm_seq_bwd(zs, cs, w, g, dc.T.contiguous().T)
        with pytest.raises(ValueError, match="contiguous"):
            kernel.lstm_seq_bwd(zs, cs, w, g.transpose(0, 1)
                                .contiguous().transpose(0, 1))
        with pytest.raises(ValueError, match="shapes"):
            kernel.lstm_seq_bwd(zs, cs[1:], w, g)
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
    """The walk's op on fake CUDA tensors: (dzs, dh0, dc0) in their shapes,
    one fake call, no launch; ``FlopCounterMode`` counts
    ``lstm_seq_bwd_flops``, the operations ``chip_smoke.py``'s bound
    takes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    s, bsz, d, h = 128, 16, 1024, 1024
    kernel.bwd_fake_calls = 0
    launches = kernel.bwd_launches
    with FakeTensorMode():
        zs = torch.empty((s, bsz, h, 4), device="cuda")
        cs = torch.empty((s + 1, bsz, h), device="cuda")
        w = torch.empty((d + h, h, 4), device="cuda")
        g = torch.empty((s, bsz, h), device="cuda")
        with FlopCounterMode(display=False) as counter:
            dzs, dh0, dc0 = torch.ops.repro_torch.lstm_seq_bwd(
                zs, cs, w, g, None)
    assert [tuple(t.shape) for t in (dzs, dh0, dc0)] == [
        (s, bsz, h, 4), (bsz, h), (bsz, h)]
    assert all(t.device.type == "cuda" for t in (dzs, dh0, dc0))
    assert (kernel.bwd_fake_calls, kernel.bwd_launches) == (1, launches)
    assert counter.get_total_flops() == lstm_seq_bwd_flops(s, bsz, h) \
        == 2 * s * bsz * h * 4 * h
    monkeypatch.setattr(chip_smoke, "HBM_BYTES_PER_S", float("inf"))
    ms, by = chip_smoke.seq_bwd_bound_ms(bsz, s, h)
    assert by == "operations"
    assert ms * 1e-3 * chip_smoke.FP32_FLOPS_PER_S == pytest.approx(
        lstm_seq_bwd_flops(s, bsz, h), rel=1e-12)


class _Ctx:
    """What an autograd.Function's forward and backward use of ``ctx``."""

    needs_input_grad = (True,) * 5 + (False, False)

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_follows_a_fake_trace(monkeypatch, reverse):
    """``LSTMSequenceFunction``'s forward and backward, called as autograd
    calls them, on fake tensors that answer ``is_cuda`` as the card's do (a
    fake CUDA tensor cannot be viewed in a CPU-only torch): S forward fake
    calls and one of the backward walk, no launch, every gradient in its
    input's shape, and the operations of S cells each way (the walk's
    carries and dX = dZ W_x^T make a step's backward over all D+H rows) plus
    one dW product over the S·B rows."""
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
    assert (kernel.fake_calls, kernel.bwd_fake_calls) == (s, 1)
    assert kernel.launches + kernel.bwd_launches == launches
    assert flops.flops == s * (lstm_cell_flops(bsz, k, h)
                               + 2 * bsz * k * 4 * h) \
        + 2 * s * bsz * k * 4 * h
