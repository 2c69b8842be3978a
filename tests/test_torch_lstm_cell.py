"""The port's LSTM cell against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
Pallas kernel runs in interpret mode, as tests/test_kernels.py runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell.kernel import lstm_cell_fwd as jax_lstm_cell_fwd
from repro.models.rnn import run_lstm
from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ops import (
    LSTMCellFunction,
    lstm_cell,
    lstm_sequence,
)
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.models.convert import (
    lstm_bias_to_kernel,
    lstm_weight_to_kernel,
)


def _cell_inputs(seed, b, d, h, dtype=np.float32):
    r = np.random.RandomState(seed)
    return (r.randn(b, d + h).astype(dtype),
            (r.randn(d + h, h, 4) * 0.1).astype(dtype),
            (r.randn(h, 4) * 0.1).astype(dtype),
            r.randn(b, h).astype(dtype))


@pytest.mark.parametrize("b,d,h,bb,bhid", [
    (64, 96, 128, 64, 64), (128, 128, 128, 128, 128), (32, 64, 256, 32, 128),
])
def test_lstm_cell_ref_matches_pallas_kernel(b, d, h, bb, bhid):
    xh, w, bias, c = _cell_inputs(0, b, d, h)
    hj, cj = jax_lstm_cell_fwd(jnp.asarray(xh), jnp.asarray(w),
                               jnp.asarray(bias), jnp.asarray(c),
                               block_b=bb, block_h=bhid, interpret=True)
    ht, ct = lstm_cell_ref(*map(torch.from_numpy, (xh, w, bias, c)))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=3e-5,
                               atol=3e-5)


def test_cpu_cell_is_the_plain_cell():
    args = tuple(map(torch.from_numpy, _cell_inputs(1, 5, 7, 9)))
    for got, want in zip(lstm_cell(*args), lstm_cell_ref(*args)):
        assert torch.equal(got, want)


def test_layout_adapter_moves_each_gate_column():
    """(D+H, 4H) column g*H + u lands at [:, u, g]; bias likewise."""
    k, h = 6, 5
    w = np.arange(k * 4 * h, dtype=np.float32).reshape(k, 4 * h)
    b = np.arange(4 * h, dtype=np.float32)
    wk, bk = lstm_weight_to_kernel(w), lstm_bias_to_kernel(b)
    assert wk.shape == (k, h, 4) and bk.shape == (h, 4)
    assert wk.flags["C_CONTIGUOUS"] and bk.flags["C_CONTIGUOUS"]
    for g in range(4):
        for u in range(h):
            np.testing.assert_array_equal(wk[:, u, g], w[:, g * h + u])
            assert bk[u, g] == b[g * h + u]


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_sequence_matches_run_lstm(reverse):
    """Forward and reverse scans over time against the JAX model's LSTM,
    through the layout adapter; fp32 summation order bounds it at 1e-5."""
    bsz, s, d, h = 3, 7, 10, 12
    r = np.random.RandomState(2)
    xs = r.randn(bsz, s, d).astype(np.float32)
    w = (r.randn(d + h, 4 * h) / np.sqrt(d + h)).astype(np.float32)
    b = (r.randn(4 * h) * 0.1).astype(np.float32)
    want = np.asarray(run_lstm({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(xs), reverse=reverse))
    zeros = torch.zeros(bsz, h)
    got = lstm_sequence(torch.from_numpy(xs), zeros, zeros,
                        torch.from_numpy(lstm_weight_to_kernel(w)),
                        torch.from_numpy(lstm_bias_to_kernel(b)),
                        reverse=reverse)
    assert got.shape == (bsz, s, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cell_gradcheck_float64():
    args = [torch.from_numpy(a).requires_grad_()
            for a in _cell_inputs(3, 4, 5, 6, np.float64)]
    assert torch.autograd.gradcheck(LSTMCellFunction.apply, tuple(args))


@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_gradient_matches_autograd_of_plain_cell(reverse):
    """The hand-written backward against autograd through the plain cell
    (``use_kernel=False``) over a whole sequence, in float64."""
    bsz, s, d, h = 2, 5, 4, 3
    r = np.random.RandomState(4)
    arrays = (r.randn(bsz, s, d), r.randn(bsz, h), r.randn(bsz, h),
              r.randn(d + h, h, 4) * 0.5, r.randn(h, 4) * 0.5)
    grads = []
    for use_kernel in (True, False):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        hs = lstm_sequence(*ts, reverse=reverse, use_kernel=use_kernel)
        grads.append(torch.autograd.grad((hs * hs).sum(), ts))
    for g1, g2 in zip(*grads):
        torch.testing.assert_close(g1, g2, rtol=1e-10, atol=1e-12)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = kernel.launches
    args = tuple(map(torch.from_numpy, _cell_inputs(5, 2, 3, 4)))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.lstm_cell_fwd(*args)
    assert kernel.launches == before


def test_cell_raises_on_a_device_without_kernel():
    args = [torch.empty(s, device="meta")
            for s in ((2, 7), (7, 4, 4), (4, 4), (2, 4))]
    with pytest.raises(ValueError, match="no kernel"):
        lstm_cell(*args)
