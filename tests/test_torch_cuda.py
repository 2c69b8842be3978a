"""The Hopper LSTM-cell kernel on a CUDA card. Without a card every test
here skips; run them on one with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_sequence
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _inputs(b, d, h, device, seed=0):
    r = np.random.RandomState(seed)
    k = d + h
    arrays = (r.randn(b, k), r.randn(k, h, 4) / np.sqrt(k),
              r.randn(h, 4) * 0.1, r.randn(b, h))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.parametrize("b,d,h", [
    (16, 1024, 512), (16, 1024, 1024), (16, 2048, 1024),   # GNMT's cells
    (5, 77, 200), (33, 50, 130), (64, 96, 128), (1, 1, 1),  # ragged
])
def test_kernel_matches_plain_cell(cuda, b, d, h):
    args = _inputs(b, d, h, cuda)
    before = kernel.launches
    hk, ck = kernel.lstm_cell_fwd(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    hp, cp = lstm_cell_ref(*args)
    torch.testing.assert_close(hk, hp, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(ck, cp, rtol=3e-5, atol=3e-5)


def test_kernel_refuses_what_it_does_not_take(cuda):
    xh, w, b, c = _inputs(4, 6, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        kernel.lstm_cell_fwd(xh.double(), w, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.lstm_cell_fwd(xh, w, b, c.T.contiguous().T)
    with pytest.raises(ValueError, match="shapes"):
        kernel.lstm_cell_fwd(xh, w, b, c[:, :4].contiguous())


def test_cuda_sequence_runs_the_kernel_and_its_gradient(cuda):
    bsz, s, d, h = 4, 6, 24, 40
    r = np.random.RandomState(1)
    arrays = (r.randn(bsz, s, d), np.zeros((bsz, h)), np.zeros((bsz, h)),
              r.randn(d + h, h, 4) / np.sqrt(d + h), r.randn(h, 4) * 0.1)
    grads, outs = [], []
    for use_kernel in (True, False):
        ts = [torch.tensor(a, dtype=torch.float32, device=cuda)
              .requires_grad_() for a in arrays]
        before = kernel.launches
        hs = lstm_sequence(*ts, reverse=True, use_kernel=use_kernel)
        assert kernel.launches - before == (s if use_kernel else 0)
        outs.append(hs)
        grads.append(torch.autograd.grad((hs * hs).sum(), ts))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for gk, gp in zip(*grads):
        torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-5)
    assert lstm_cell(*_inputs(2, 3, 4, cuda))[0].is_cuda
