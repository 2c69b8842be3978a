"""The Hopper kernels (LSTM cell, flash attention and its backward, WKV6,
the selective scan) on a CUDA card.
Without a card every test here skips; run them on one with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_bwd_plain,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_ref_lse,
)
from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell import ref as lstm_ref
from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_sequence
from repro_torch.kernels.lstm_cell.ref import (
    lstm_cell_bwd_plain,
    lstm_cell_fwd_plain,
    lstm_cell_ref,
)
from repro_torch.kernels.mamba_scan import kernel as mamba_kernel
from repro_torch.kernels.mamba_scan.ops import (
    mamba_scan,
    mamba_scan_bwd_plain,
)
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.rwkv6_wkv import kernel as wkv6_kernel
from repro_torch.kernels.rwkv6_wkv import ops as wkv6_ops


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
    (1, 1024, 512), (1, 1024, 1024), (1, 2048, 1024),      # at batch 1
    (40, 1024, 512), (40, 1024, 1024), (40, 2048, 1024),   # three tiles
    (16, 997, 256),        # K = 1253: no cluster split divides it, and odd
    (16, 1028, 1024),      # K = 2052: a multiple of 4 that no split divides
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


def test_kernel_writes_z_and_h_into_strided_rows(cuda):
    """The forward's optional outputs: z (B, H, 4) equal to the plain
    version's preactivations, h written into the tail of wider rows (a
    sequence's next [x; h] row) and nothing else of them; h and c the same
    to the bit as without them."""
    xh, w, b, c = _inputs(16, 1024, 512, cuda)
    rows = torch.full((16, 700 + 512), float("nan"), device=cuda)
    z = torch.empty(16, 512, 4, device=cuda)
    h, cn = kernel.lstm_cell_fwd(xh, w, b, c, h_out=rows[:, 700:], z_out=z)
    torch.cuda.synchronize()
    assert h.data_ptr() == rows[:, 700:].data_ptr()
    assert torch.isnan(rows[:, :700]).all()
    hp, cp, zp = lstm_cell_fwd_plain(xh, w, b, c)
    torch.testing.assert_close(z, zp, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(h, hp, rtol=3e-5, atol=3e-5)
    h0, c0 = kernel.lstm_cell_fwd(xh, w, b, c)
    assert torch.equal(h, h0) and torch.equal(cn, c0)


def _bwd_inputs(b, d, h, device, seed=0):
    """(z, c, w, dh, dc, dh_up): the plain forward's z at ``_inputs`` and
    random cotangents."""
    xh, w, bias, c = _inputs(b, d, h, device, seed)
    r = np.random.RandomState(seed + 1)
    dh, dc, up = (torch.tensor(r.randn(b, h), dtype=torch.float32,
                               device=device) for _ in range(3))
    return lstm_cell_fwd_plain(xh, w, bias, c)[2], c, w, dh, dc, up


@pytest.mark.parametrize("b,d,h", [
    (16, 1024, 512), (16, 1024, 1024), (16, 2048, 1024),   # GNMT's cells
    (1, 1024, 1024), (40, 1024, 1024),     # batch 1, three batch tiles
    (16, 1024, 2048),      # 256 units a block: two chunks of dz
    (16, 997, 256), (5, 77, 200), (33, 50, 130), (1, 1, 1),  # ragged
])
@pytest.mark.parametrize("up", [False, True])
def test_bwd_kernel_matches_plain_backward(cuda, b, d, h, up):
    """dz, dxh and dc_prev against ``lstm_cell_bwd_plain`` (fp32, rtol =
    atol = 3e-5, the forward's tolerance: dxh sums 4H products in another
    order), with and without the second share of dh; two calls equal to
    the bit (fixed-order sums, no atomics)."""
    z, c, w, dh, dc, dh_up = _bwd_inputs(b, d, h, cuda)
    dh_up = dh_up if up else None
    before = kernel.bwd_launches
    got = kernel.lstm_cell_bwd(z, c, w, dh, dc, dh_up)
    again = kernel.lstm_cell_bwd(z, c, w, dh, dc, dh_up)
    torch.cuda.synchronize()
    assert kernel.bwd_launches == before + 2
    want = lstm_cell_bwd_plain(z, c, w, dh, dc, dh_up)
    for g, a, p in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, p, rtol=3e-5, atol=3e-5)


def test_bwd_kernel_reads_dh_from_strided_rows(cuda):
    """dh given as the tail of wider rows (the next step's dxh) gives the
    same gradients to the bit as a contiguous copy."""
    z, c, w, dh, dc, up = _bwd_inputs(16, 96, 128, cuda)
    rows = torch.randn(16, 96 + 128, device=cuda)
    rows[:, 96:] = dh
    got = kernel.lstm_cell_bwd(z, c, w, rows[:, 96:], dc, up)
    want = kernel.lstm_cell_bwd(z, c, w, dh, dc, up)
    assert all(torch.equal(g, p) for g, p in zip(got, want))


def test_bwd_kernel_refuses_what_it_does_not_take(cuda):
    z, c, w, dh, dc, up = _bwd_inputs(4, 6, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        kernel.lstm_cell_bwd(z.double(), c, w, dh, dc)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.lstm_cell_bwd(z, c.T.contiguous().T, w, dh, dc)
    with pytest.raises(ValueError, match="shapes"):
        kernel.lstm_cell_bwd(z, c, w, dh, dc[:, :4].contiguous())
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.lstm_cell_bwd(z, c, w, dh, dc, up.cpu())


@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_sequence_backward_runs_the_backward_kernel(cuda, reverse):
    """A layer with a state in, forward and backward: one forward and one
    backward launch a step, no plain backward on the card, and every
    gradient (xs, h0, c0, w, b) within 1e-4 / 1e-5 of autograd through
    the plain cell on the card."""
    bsz, s, d, h = 16, 9, 48, 40
    r = np.random.RandomState(3)
    arrays = (r.randn(bsz, s, d), r.randn(bsz, h), r.randn(bsz, h),
              r.randn(d + h, h, 4) / np.sqrt(d + h), r.randn(h, 4) * 0.1)
    g = torch.tensor(r.randn(bsz, s, h), dtype=torch.float32, device=cuda)
    grads, outs = [], []
    plain_before = lstm_ref.plain_cuda_calls
    for use_kernel in (True, False):
        ts = [torch.tensor(a, dtype=torch.float32, device=cuda)
              .requires_grad_() for a in arrays]
        before = (kernel.launches, kernel.bwd_launches)
        hs = lstm_sequence(*ts, reverse=reverse, use_kernel=use_kernel)
        grads.append(torch.autograd.grad(hs, ts, g))
        torch.cuda.synchronize()
        moved = (kernel.launches - before[0], kernel.bwd_launches - before[1])
        assert moved == ((s, s) if use_kernel else (0, 0))
        outs.append(hs)
    assert lstm_ref.plain_cuda_calls == plain_before
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for gk, gp in zip(*grads):
        torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-5)


FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


def _flash_inputs(b, hq, hkv, sq, skv, dh, dtype, device, seed=0):
    """q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh) cut from wider
    projections, as a fused qkv projection gives them, so their strides are
    real: the head dimension contiguous, the sequence stride wider."""
    r = np.random.RandomState(seed)
    width = (hq + 2 * hkv) * dh
    qp = torch.tensor(r.randn(b, sq, width), dtype=dtype, device=device)
    kvp = qp if sq == skv else torch.tensor(r.randn(b, skv, width),
                                            dtype=dtype, device=device)
    q = qp[..., :hq * dh].unflatten(-1, (hq, dh))
    k = kvp[..., hq * dh:(hq + hkv) * dh].unflatten(-1, (hkv, dh))
    v = kvp[..., (hq + hkv) * dh:].unflatten(-1, (hkv, dh))
    return q, k, v


def _flash_ref(q, k, v, causal):
    b, _, hq, dh = q.shape

    def fold(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], dh).contiguous()
    out = attention_ref(fold(q), fold(k), fold(v), causal)
    return out.unflatten(0, (b, hq)).transpose(1, 2)


def _check_flash(q, k, v, causal, path):
    before = (flash.launches, flash.launches_tc, flash.launches_simt)
    out, lse = flash.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    moved = (flash.launches - before[0], flash.launches_tc - before[1],
             flash.launches_simt - before[2])
    assert moved == ((1, 1, 0) if path == "tc" else (1, 0, 1))
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.is_contiguous()
    tol = FLASH_TOL[q.dtype]
    ref = _flash_ref(q, k, v, causal).float()
    # atol scales down with max |o| below 1: non-causal rows over many
    # keys average them, so |o| is small and a fixed atol would hide a
    # dropped key range
    torch.testing.assert_close(out.float(), ref, rtol=tol,
                               atol=tol * min(1.0, ref.abs().max().item()))
    # the rows' log-sum-exp beside o, for the backward kernel
    b, sq, hq, dh = q.shape

    def fold(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], dh).contiguous()
    want_lse = attention_ref_lse(fold(q), fold(k), fold(v), causal)[1]
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    torch.testing.assert_close(lse, want_lse.view(b, hq, sq), rtol=0,
                               atol=5e-4)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", [
    (1, 2, 2, 128, 128, 64, True), (2, 2, 1, 256, 256, 64, True),
    (1, 4, 1, 128, 256, 128, False), (2, 4, 2, 384, 384, 64, True),
    (4, 24, 2, 160, 160, 128, True),       # serving shape, ragged width
    (8, 24, 2, 16, 16, 128, True),         # training: below one tile,
    (8, 24, 2, 80, 80, 128, True),         # ragged, and the longest SL
    (8, 24, 2, 256, 256, 128, True),
    (3, 5, 1, 100, 100, 64, True), (2, 3, 1, 33, 77, 40, False),  # ragged
    (2, 2, 1, 128, 256, 128, True),        # Sq < Skv: top-left causal
    (1, 3, 3, 1, 1, 128, True), (2, 1, 1, 5, 300, 16, True),
    (2, 4, 4, 256, 256, 192, True),        # MLA's head_dim
    (2, 4, 4, 100, 100, 192, True), (1, 4, 1, 100, 300, 192, False),
    (1, 4, 4, 1500, 1500, 64, False),      # whisper's encoder
    (2, 4, 4, 64, 1500, 64, False),        # whisper's cross-attention
    (2, 4, 4, 1, 1500, 64, False),         # ... at decode
    (2, 4, 4, 64, 64, 64, True),           # whisper's decoder prefill
    (1, 12, 2, 544, 544, 128, True),       # GQA group 6 (internlm2-20b)
    (1, 16, 2, 544, 544, 128, True),       # group 8 (qwen2-72b, llava)
    (1, 2, 1, 70, 90, 256, True), (1, 2, 2, 33, 33, 200, False),  # dh > 192
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_ref(cuda, b, hq, hkv, sq, skv, dh, causal,
                                  dtype):
    """Tolerance as the JAX package's kernel test: 2e-3 in float32, 2e-2
    in bfloat16 (both sides compute in float32; bf16 rounds the output),
    with atol scaled down where max |o| is below 1."""
    q, k, v = _flash_inputs(b, hq, hkv, sq, skv, dh, dtype, cuda,
                            seed=hq * 1000 + sq)
    _check_flash(q, k, v, causal, flash.select_path(dtype, dh))


_FLASH_EDGES = [                           # (Sq, Skv, causal)
    (1, 1, True), (100, 100, True), (544, 544, True), (2048, 2048, True),
    (100, 300, True), (544, 1000, True),   # Sq < Skv, causal
    (100, 300, False), (300, 100, False),  # non-causal, either way round
    (300, 100, True),                      # Sq > Skv, causal
]


@pytest.mark.parametrize("sq,skv,causal", _FLASH_EDGES)
@pytest.mark.parametrize("group", [1, 4, 12])
@pytest.mark.parametrize("dh", [64, 128, 192])
def test_flash_tensor_core_path_edges(cuda, dh, group, sq, skv, causal):
    """bf16 at head_dim 64, 128 and 192 (64-key tiles): the wgmma/TMA
    path, on strided slices, at GQA groups 1, 4 (jamba) and 12
    (starcoder2-3b)."""
    q, k, v = _flash_inputs(2, 2 * group, 2, sq, skv, dh, torch.bfloat16,
                            cuda, seed=sq + group)
    _check_flash(q, k, v, causal, "tc")


@pytest.mark.parametrize("sq,skv,causal", _FLASH_EDGES)
@pytest.mark.parametrize("group", [1, 4, 12])
@pytest.mark.parametrize("dh", [64, 128, 192, 256])
def test_flash_cuda_core_path_edges(cuda, dh, group, sq, skv, causal):
    """fp32 at the same edges: the CUDA-core path, on strided slices."""
    q, k, v = _flash_inputs(1, 2 * group, 2, sq, skv, dh, torch.float32,
                            cuda, seed=sq + group)
    _check_flash(q, k, v, causal, "simt")


def test_flash_paths_count_only_their_own_launches(cuda):
    """bf16 at head_dim 64/128/192 moves launches_tc; fp32 and bf16 at
    other head dims move launches_simt; launches is their sum."""
    for dtype, dh, path in ((torch.bfloat16, 128, "tc"),
                            (torch.bfloat16, 64, "tc"),
                            (torch.bfloat16, 192, "tc"),
                            (torch.bfloat16, 32, "simt"),
                            (torch.bfloat16, 256, "simt"),
                            (torch.float32, 192, "simt"),
                            (torch.float32, 128, "simt"),
                            (torch.float32, 64, "simt")):
        assert flash.select_path(dtype, dh) == path
        _check_flash(*_flash_inputs(1, 4, 2, 64, 64, dh, dtype, cuda),
                     True, path)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or"):
        flash.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="shapes"):
        flash.flash_attention_fwd(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 8, 2, 264, device=cuda)
        flash.flash_attention_fwd(big, big, big)
    with pytest.raises(ValueError, match="not contiguous"):
        flash.flash_attention_fwd(
            q.transpose(1, 3).contiguous().transpose(1, 3), q, q)
    with pytest.raises(ValueError, match="TMA"):
        qb = torch.zeros(1, 8, 4, 65, device=cuda, dtype=torch.bfloat16)
        flash.flash_attention_fwd(qb[..., 1:], qb[..., 1:], qb[..., 1:])


@pytest.mark.parametrize("sq", [1, 64, 1500])
def test_flash_bf16_non_causal_cross_attention(cuda, sq):
    """whisper's cross-attention in bf16 at head_dim 64: Sq < Skv = 1500
    (Sq = 1 at decode), non-causal, on the tensor-core path."""
    q, k, v = _flash_inputs(4, 16, 16, sq, 1500, 64, torch.bfloat16, cuda,
                            seed=sq)
    _check_flash(q, k, v, False, "tc")


def test_flash_op_gradient_on_the_card(cuda):
    r = np.random.RandomState(7)
    ts = [torch.tensor(r.randn(*s), dtype=torch.float32, device=cuda)
          .requires_grad_() for s in ((2, 40, 4, 32), (2, 40, 2, 32),
                                      (2, 40, 2, 32))]
    before = (flash.launches, flash.bwd_launches, flash.bwd_launches_simt,
              flash_ops.plain_cuda_calls)
    out = flash_attention(*ts)
    assert flash.launches == before[0] + 1
    grads = torch.autograd.grad((out * out).sum(), ts)
    assert (flash.bwd_launches, flash.bwd_launches_simt,
            flash_ops.plain_cuda_calls) == (before[1] + 1, before[2] + 1,
                                            before[3])
    ref = [t.detach().clone().requires_grad_() for t in ts]
    b = ref[0].shape[0]
    fold = [t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
            for t in ref]
    want_out = attention_ref(*fold).reshape(b, -1, 40, 32).transpose(1, 2)
    want = torch.autograd.grad((want_out * want_out).sum(), ref)
    torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# the flash backward against the plain VJP, of its max |plain|: fp32 to
# float noise; bf16 as the forward's kernel test (P and dS rounded to bf16
# for their products, each gradient to bf16)
FLASH_BWD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}


def _check_flash_bwd(q, k, v, causal, path, seed=0):
    """The backward kernel on the forward kernel's o and lse and a random
    cotangent, against ``flash_bwd_plain``: each gradient in its input's
    type and shape, contiguous, within ``FLASH_BWD_TOL`` of its max
    |plain|; a second call gives the same gradients to the bit (no
    atomics: dQ's parts are added in a fixed order); the workspace has
    ``bwd_workspace``'s size; the path's counters move by one a call, the
    plain VJP's CUDA count only by the comparison's own call."""
    o, lse = flash.flash_attention_fwd(q, k, v, causal)
    g = torch.tensor(np.random.RandomState(seed).randn(*q.shape),
                     dtype=q.dtype, device=q.device)
    before = (flash.bwd_launches, flash.bwd_launches_tc,
              flash.bwd_launches_simt)
    *got, work = flash.flash_attention_bwd(q, k, v, o, lse, g, causal)
    again = flash.flash_attention_bwd(q, k, v, o, lse, g, causal)[:3]
    torch.cuda.synchronize()
    moved = (flash.bwd_launches - before[0], flash.bwd_launches_tc
             - before[1], flash.bwd_launches_simt - before[2])
    assert moved == ((2, 2, 0) if path == "tc" else (2, 0, 2))
    b, sq, hq, dh = q.shape
    assert work.dtype == torch.float32 and work.numel() == \
        flash.bwd_workspace(b, hq, k.shape[2], sq, k.shape[1], dh, path)
    for name, gt, ga in zip("qkv", got, again):
        assert torch.equal(gt, ga), name
    want = flash_bwd_plain(q, k, v, g, causal)
    for name, gt, w, t in zip("qkv", got, want, (q, k, v)):
        assert gt.dtype == t.dtype and gt.shape == t.shape
        assert gt.is_contiguous()
        err = (gt.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        # with one key dq is 0 by the function (dS = P (dP - D) = dP - dP):
        # the kernel's D and dP, summed in different orders, leave float
        # noise of the unit-scale inputs
        assert err <= FLASH_BWD_TOL[t.dtype] * scale \
            or (scale == 0 and err <= 1e-5), (name, err, scale)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", [
    # the CPU tests' cases (tests/test_torch_flash_attention_bwd.py)
    (2, 4, 4, 128, 128, 64, True), (1, 4, 1, 96, 128, 128, True),
    (1, 12, 1, 128, 96, 128, True), (2, 4, 1, 100, 100, 192, True),
    (1, 12, 1, 64, 128, 192, False), (1, 4, 4, 128, 80, 64, False),
    (1, 8, 2, 100, 100, 40, True), (2, 4, 1, 33, 77, 40, False),
    # the training phases' shapes at batch 2
    (2, 24, 2, 144, 144, 128, True),       # starcoder2-3b
    (2, 24, 2, 1024, 1024, 128, True),
    (2, 32, 8, 144, 144, 128, True),       # jamba's attention
    (2, 128, 128, 144, 144, 192, True),    # deepseek-v3's MLA
    (2, 16, 16, 1500, 1500, 64, False),    # whisper's encoder
    (2, 16, 16, 144, 144, 64, True),       # ... decoder self-attention
    (2, 16, 16, 144, 1500, 64, False),     # ... cross-attention
    (1, 2, 2, 1, 1, 128, True), (1, 2, 1, 70, 90, 256, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain_vjp(cuda, b, hq, hkv, sq, skv, dh,
                                            causal, dtype):
    q, k, v = _flash_inputs(b, hq, hkv, sq, skv, dh, dtype, cuda,
                            seed=hq * 1000 + sq)
    _check_flash_bwd(q, k, v, causal, flash.select_path(dtype, dh), seed=sq)


@pytest.mark.parametrize("sq,skv,causal", _FLASH_EDGES)
@pytest.mark.parametrize("group", [1, 4, 12])
@pytest.mark.parametrize("dh", [64, 128, 192])
def test_flash_bwd_tensor_core_path_edges(cuda, dh, group, sq, skv, causal):
    """bf16 at head_dim 64, 128 and 192: the wgmma/TMA path, on strided
    slices, at the forward's edges and GQA groups (groups 4 and 12 split
    over blocks: ``bwd_parts``)."""
    q, k, v = _flash_inputs(2, 2 * group, 2, sq, skv, dh, torch.bfloat16,
                            cuda, seed=sq + group)
    _check_flash_bwd(q, k, v, causal, "tc", seed=skv)


@pytest.mark.parametrize("sq,skv,causal", _FLASH_EDGES)
@pytest.mark.parametrize("group", [1, 4, 12])
@pytest.mark.parametrize("dh", [64, 128, 192, 256])
def test_flash_bwd_cuda_core_path_edges(cuda, dh, group, sq, skv, causal):
    """fp32 at the same edges: the CUDA-core path."""
    q, k, v = _flash_inputs(1, 2 * group, 2, sq, skv, dh, torch.float32,
                            cuda, seed=sq + group)
    _check_flash_bwd(q, k, v, causal, "simt", seed=skv)


def test_flash_bwd_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    o, lse = flash.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="lse must"):
        flash.flash_attention_bwd(q, q, q, o, lse[:, :2], o)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        flash.flash_attention_bwd(q, q, q, o, lse.cpu(), o)
    with pytest.raises(ValueError, match="g is"):
        flash.flash_attention_bwd(q, q, q, o, lse, o[:, :4])


def test_model_prefill_runs_the_flash_kernel(cuda):
    """A tiny starcoder2-3b on the card: every layer's prefill attention is
    one kernel launch, and the logits agree with the plain attention path;
    decode runs no kernel."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import build_model

    cfg = smoke_config("starcoder2-3b").with_overrides(num_layers=3)
    model = build_model(cfg, device=cuda, seed=0)
    toks = torch.as_tensor(np.random.RandomState(0).randint(1, 512, (2, 40)),
                           device=cuda)
    outs = []
    with torch.inference_mode():
        for use_kernel in (True, False):
            model.use_kernel = use_kernel
            before = flash.launches
            logits, caches = model.prefill({"tokens": toks}, pos0=5)
            assert flash.launches - before == (3 if use_kernel else 0)
            outs.append(logits)
        cache = model.init_cache(2, 41)
        for dst, src in zip(cache, caches):
            for d, s in zip(dst, src):
                d[:, :40] = s
        before = flash.launches
        model.decode_step(cache, logits[:, -1].argmax(-1)[:, None], 40)
        assert flash.launches == before
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,per_prefill,per_decode", [
    ("deepseek-v3-671b", 2, 0),     # 2 MLA layers: expanded prefill only
    ("llava-next-34b", 2, 0),       # with 16 image patches in front
    ("whisper-medium", 6, 2),       # 2 encoder + 2 x 2 decoder; cross at
])                                  # decode
def test_zoo_runs_the_flash_kernel(cuda, arch, per_prefill, per_decode):
    """Smoke-size models on the card: each prefill launches the kernel
    once per attention (MLA at its qk head_dim, whisper's encoder and
    cross-attention non-causal), each decode step once per cross-attention;
    the logits of a prefill and two decode steps agree with the plain
    path."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import build_model

    cfg = smoke_config(arch)
    model = build_model(cfg, device=cuda, seed=0)
    r = np.random.RandomState(0)
    batch = {"tokens": torch.as_tensor(r.randint(1, 512, (2, 40)),
                                       device=cuda)}
    if cfg.frontend == "image_patches":
        batch["patches"] = torch.tensor(r.randn(2, 16, cfg.d_model),
                                        dtype=torch.float32, device=cuda)
    if cfg.encoder is not None:
        batch["frames"] = torch.tensor(
            r.randn(2, cfg.encoder.max_source_len, cfg.d_model),
            dtype=torch.float32, device=cuda)
    width = 40 + (16 if "patches" in batch else 0)
    outs = []
    with torch.inference_mode():
        for use_kernel in (True, False):
            model.use_kernel = use_kernel
            before = flash.launches
            logits, pre = model.prefill(batch)
            cache = model.init_cache(2, width + 2, prefix=pre)
            steps = [logits[:, -1]]
            for i in range(2):
                tok = steps[-1].argmax(-1)[:, None]
                lg, cache = model.decode_step(cache, tok, width + i)
                steps.append(lg)
            want = (per_prefill + 2 * per_decode) if use_kernel else 0
            assert flash.launches - before == want
            outs.append(torch.stack(steps))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-5)


def _wkv6_inputs(b, s, h, dh, with_state, device, seed=0):
    """r, k, v ~ N(0, 1); lw = -exp(clip(N(0, 1), -8, 0)) in [-1, 0), as the
    JAX package's kernel test draws it; u and state0 ~ N(0, 1)."""
    r = np.random.RandomState(seed)
    arrays = [r.randn(b, s, h, dh) for _ in range(3)]
    arrays.append(-np.exp(np.clip(r.randn(b, s, h, dh), -8, 0)))
    arrays.append(r.randn(h, dh))
    out = [torch.tensor(a, dtype=torch.float32, device=device)
           for a in arrays]
    state0 = (torch.tensor(r.randn(b, h, dh, dh), dtype=torch.float32,
                           device=device) if with_state else None)
    return out + [state0]


@pytest.mark.parametrize("b,s,h,dh,with_state", [
    (4, 256, 40, 64, False),               # rwkv6-3b's prefill shape
    (4, 100, 40, 64, True),                # ragged: S not a multiple of 32
    (4, 1, 40, 64, True),                  # a decode step
    (2, 33, 3, 32, True), (1, 64, 2, 64, False), (3, 97, 5, 64, True),
])
def test_wkv6_kernel_matches_plain(cuda, b, s, h, dh, with_state):
    """y and the final state within 5e-4, the JAX kernel test's tolerance."""
    args = _wkv6_inputs(b, s, h, dh, with_state, cuda, seed=s)
    before = wkv6_kernel.launches
    y, st = wkv6_kernel.wkv6_fwd(*args)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == before + 1
    assert y.shape == (b, s, h, dh) and st.shape == (b, h, dh, dh)
    yp, sp = wkv6_ops.wkv6_plain(*args)
    torch.testing.assert_close(y, yp, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(st, sp, rtol=5e-4, atol=5e-4)


def _wkv6_oracle64(r, k, v, lw, u, state0=None):
    """The sequential recurrence in float64, (B, S, H, dh) layout."""
    r, k, v, lw, u = (t.double() for t in (r, k, v, lw, u))
    b, s, h, dh = r.shape
    st = (torch.zeros(b, h, dh, dh, dtype=torch.float64, device=r.device)
          if state0 is None else state0.double())
    w = torch.exp(lw)
    ys = []
    for t in range(s):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, st)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        st = w[:, t, :, :, None] * st + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=1).float(), st.float()


@pytest.mark.parametrize("lw_value", [-1.0, -1e-6])
def test_wkv6_kernel_at_the_clamps_ends(cuda, lw_value):
    """lw at both ends of the model's clamp [-1, -1e-6], rwkv6-3b's 40
    heads over S = 1536 (48 chunks), within 5e-4: against the plain
    version at -1 (exp(-cumsum) at its largest); at -1e-6 against the
    float64 recurrence, because there the fp32 plain version's rounded
    decay compounds over 1536 steps to more than the tolerance itself
    (tests/test_torch_wkv6.py shows it on the CPU)."""
    r, k, v, lw, u, _ = _wkv6_inputs(1, 1536, 40, 64, False, cuda, seed=3)
    lw = torch.full_like(lw, lw_value)
    y, st = wkv6_kernel.wkv6_fwd(r, k, v, lw, u)
    torch.cuda.synchronize()
    if lw_value == -1.0:
        yp, sp = wkv6_ops.wkv6_plain(r, k, v, lw, u, None)
    else:
        yp, sp = _wkv6_oracle64(r, k, v, lw, u)
    torch.testing.assert_close(y, yp, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(st, sp, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("s", [31, 32, 33, 63, 64, 65, 128])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_kernel_at_the_chunk_edges(cuda, s, with_state):
    """S one short of, at and one past one and two of the kernel's 32-step
    chunks (the Pallas kernel's 64), and four: a ragged tail chunk neither
    decays nor adds to the state."""
    args = _wkv6_inputs(2, s, 5, 64, with_state, cuda, seed=s)
    y, st = wkv6_kernel.wkv6_fwd(*args)
    torch.cuda.synchronize()
    yp, sp = wkv6_ops.wkv6_plain(*args)
    torch.testing.assert_close(y, yp, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(st, sp, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("splits", [(100, 60), (64, 64), (1,) * 8])
def test_wkv6_kernel_calls_chain_through_the_state(cuda, splits):
    """Prefills of S1 then S2 from S1's final state, and eight S = 1
    decode steps, give the y and final state of one call over the whole
    sequence."""
    s = sum(splits)
    r, k, v, lw, u, s0 = _wkv6_inputs(2, s, 6, 64, True, cuda, seed=s)
    y_all, st_all = wkv6_kernel.wkv6_fwd(r, k, v, lw, u, s0)
    ys, st, t0 = [], s0, 0
    for n in splits:
        part = (x[:, t0:t0 + n].contiguous() for x in (r, k, v, lw))
        y, st = wkv6_kernel.wkv6_fwd(*part, u, st)
        ys.append(y)
        t0 += n
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(ys, dim=1), y_all, rtol=5e-4,
                               atol=5e-4)
    torch.testing.assert_close(st, st_all, rtol=5e-4, atol=5e-4)


def test_wkv6_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, lw, u, s0 = _wkv6_inputs(2, 8, 3, 64, True, cuda)
    with pytest.raises(ValueError, match="float32"):
        wkv6_kernel.wkv6_fwd(r.double(), k, v, lw, u, s0)
    with pytest.raises(ValueError, match="shapes"):
        wkv6_kernel.wkv6_fwd(r, k, v, lw, u[:2].contiguous(), s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_kernel.wkv6_fwd(r, k, v, lw, u, s0.transpose(2, 3))
    with pytest.raises(ValueError, match="head_dim"):
        r48 = torch.zeros(2, 8, 3, 48, device=cuda)
        wkv6_kernel.wkv6_fwd(r48, r48, r48, r48, torch.zeros(3, 48,
                                                             device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel.wkv6_fwd(r.cpu(), k, v, lw, u, s0)


def _grads_close(got, want, tol):
    """Each gradient within ``tol`` of its plain one's max |.|, None where
    the plain one is None."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, i
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * max(scale, 1e-30), (i, err, scale)


def _wkv6_cotangents(b, s, h, dh, with_gs, device, seed):
    r = np.random.RandomState(seed)
    gy = torch.tensor(r.randn(b, s, h, dh), dtype=torch.float32,
                      device=device)
    gs = (torch.tensor(r.randn(b, h, dh, dh), dtype=torch.float32,
                       device=device) if with_gs else None)
    return gy, gs


@pytest.mark.parametrize("s", [1, 31, 32, 33, 63, 64, 65, 128,
                               160, 257, 544])
@pytest.mark.parametrize("with_state,with_gs", [
    (False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("dh", [32, 64])
def test_wkv6_bwd_kernel_matches_plain(cuda, s, with_state, with_gs, dh):
    """The backward kernel against the plain version's VJP
    (``wkv6_bwd_plain``) in fp32, around its 32-step chunks (one step, a
    chunk and one either side, two chunks and one either side), at 5
    chunks, and at 9 and 17, one past the chunk walk's 8 chunks loaded
    ahead and past twice that, with and without a state in and a state
    cotangent: every gradient within 5e-4 of max |plain|; one launch;
    dstate0 only where state0 is given."""
    args = _wkv6_inputs(2, s, 3, dh, with_state, cuda, seed=s + dh)
    gy, gs = _wkv6_cotangents(2, s, 3, dh, with_gs, cuda, seed=s + 1)
    before = wkv6_kernel.bwd_launches
    got = wkv6_kernel.wkv6_bwd(*args, gy, gs)[:6]
    torch.cuda.synchronize()
    assert wkv6_kernel.bwd_launches == before + 1
    _grads_close(got, wkv6_ops.wkv6_bwd_plain(*args, gy, gs), 5e-4)


@pytest.mark.parametrize("lw_value", [-1.0, -1e-6])
def test_wkv6_bwd_kernel_at_the_clamps_ends(cuda, lw_value):
    """lw at both ends of the model's clamp over S = 256 with rwkv6-3b's
    40 heads, a state in and a state cotangent: every gradient within
    5e-4 of max |plain|."""
    r, k, v, lw, u, s0 = _wkv6_inputs(1, 256, 40, 64, True, cuda, seed=4)
    lw = torch.full_like(lw, lw_value)
    gy, gs = _wkv6_cotangents(1, 256, 40, 64, True, cuda, seed=5)
    got = wkv6_kernel.wkv6_bwd(r, k, v, lw, u, s0, gy, gs)[:6]
    torch.cuda.synchronize()
    _grads_close(got, wkv6_ops.wkv6_bwd_plain(r, k, v, lw, u, s0, gy, gs),
                 5e-4)


def test_wkv6_bwd_kernel_at_4096_steps_full_width(cuda):
    """One sequence of 4096 steps (the dry run's train_4k) at rwkv6-3b's
    40 heads of 64, with a state in and a state cotangent: 128 chunks
    walked, every gradient within 5e-4 of max |plain|."""
    args = _wkv6_inputs(1, 4096, 40, 64, True, cuda, seed=11)
    gy, gs = _wkv6_cotangents(1, 4096, 40, 64, True, cuda, seed=12)
    got = wkv6_kernel.wkv6_bwd(*args, gy, gs)[:6]
    torch.cuda.synchronize()
    _grads_close(got, wkv6_ops.wkv6_bwd_plain(*args, gy, gs), 5e-4)


def test_wkv6_bwd_kernel_repeats_bit_for_bit(cuda):
    """du is summed over the batch in order, without atomics: two calls
    give the same bits."""
    args = _wkv6_inputs(4, 100, 5, 64, True, cuda, seed=9)
    gy, gs = _wkv6_cotangents(4, 100, 5, 64, True, cuda, seed=10)
    one = wkv6_kernel.wkv6_bwd(*args, gy, gs)[:6]
    two = wkv6_kernel.wkv6_bwd(*args, gy, gs)[:6]
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_wkv6_bwd_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, lw, u, s0 = _wkv6_inputs(2, 8, 3, 64, True, cuda)
    gy, gs = _wkv6_cotangents(2, 8, 3, 64, True, cuda, seed=1)
    with pytest.raises(ValueError, match="float32"):
        wkv6_kernel.wkv6_bwd(r, k, v, lw, u, s0, gy.double(), gs)
    with pytest.raises(ValueError, match="shapes"):
        wkv6_kernel.wkv6_bwd(r, k, v, lw, u, s0, gy[:, :4].contiguous(), gs)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_kernel.wkv6_bwd(r, k, v, lw, u, s0, gy, gs.transpose(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel.wkv6_bwd(r, k, v, lw, u, s0, gy.cpu(), gs)


def test_wkv6_op_gradient_on_the_card(cuda):
    """The op runs the kernel forward and the backward kernel back, one
    launch each; its gradients match the plain version's own, state0
    included. The loss is linear in y and the state, so the forwards'
    difference stays out of the cotangents."""
    arrays = _wkv6_inputs(2, 40, 3, 64, True, cuda, seed=7)
    r = np.random.RandomState(8)
    cy = torch.tensor(r.randn(2, 40, 3, 64), dtype=torch.float32, device=cuda)
    cs = torch.tensor(r.randn(2, 3, 64, 64), dtype=torch.float32, device=cuda)
    ts = [a.clone().requires_grad_() for a in arrays]
    before = (wkv6_kernel.launches, wkv6_kernel.bwd_launches)
    y, st = wkv6_ops.wkv6(*ts)
    assert wkv6_kernel.launches == before[0] + 1
    grads = torch.autograd.grad((y * cy).sum() + (st * cs).sum(), ts)
    assert (wkv6_kernel.launches, wkv6_kernel.bwd_launches) \
        == (before[0] + 1, before[1] + 1)
    ref = [a.clone().requires_grad_() for a in arrays]
    yp, sp = wkv6_ops.wkv6_plain(*ref)
    want = torch.autograd.grad((yp * cy).sum() + (sp * cs).sum(), ref)
    torch.testing.assert_close(y, yp, rtol=5e-4, atol=5e-4)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_rwkv_model_runs_the_wkv6_kernel(cuda):
    """A tiny rwkv6-3b on the card: every layer's WKV is one kernel launch
    in prefill and in each decode step, and the logits agree with the
    plain path's (fp32, TF32 off)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import build_model

    cfg = smoke_config("rwkv6-3b").with_overrides(num_layers=3)
    model = build_model(cfg, device=cuda, seed=0)
    toks = torch.as_tensor(np.random.RandomState(0).randint(1, 512, (2, 40)),
                           device=cuda)
    outs = []
    with torch.inference_mode():
        for use_kernel in (True, False):
            model.use_kernel = use_kernel
            before = wkv6_kernel.launches
            logits, pre = model.prefill({"tokens": toks})
            cache = model.init_cache(2, 48, prefix=pre)
            tok = logits[:, -1].argmax(-1)[:, None]
            steps = [logits[:, -1]]
            for step in range(3):
                lg, cache = model.decode_step(cache, tok, 40 + step)
                tok = lg.argmax(-1)[:, None]
                steps.append(lg)
            assert wkv6_kernel.launches - before == (3 * 4 if use_kernel
                                                     else 0)
            outs.append(torch.stack(steps))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


def _mamba_inputs(b, s, d, n, with_state, device, x_dtype=torch.float32,
                  seed=0):
    """x ~ N(0, 1), delta = softplus(N(0, 1) - 2), a = -exp(0.3 N(0, 1)),
    B, C, D ~ N(0, 1), as the JAX package's kernel test draws them; state0
    ~ N(0, 1)."""
    r = np.random.RandomState(seed)
    arrays = [r.randn(b, s, d), np.log1p(np.exp(r.randn(b, s, d) - 2)),
              -np.exp(r.randn(d, n) * 0.3), r.randn(b, s, n),
              r.randn(b, s, n), r.randn(d)]
    out = [torch.tensor(a, dtype=torch.float32, device=device)
           for a in arrays]
    out[0] = out[0].to(x_dtype)
    state0 = (torch.tensor(r.randn(b, d, n), dtype=torch.float32,
                           device=device) if with_state else None)
    return out + [state0]


@pytest.mark.parametrize("b,s,d,n,with_state", [
    (4, 256, 8192, 16, False),             # jamba's prefill width
    (4, 1, 8192, 16, True),                # a decode step
    (4, 100, 8192, 16, True),              # ragged: S not a multiple of 32
    (2, 128, 128, 8, False), (1, 64, 256, 16, False),
    (2, 96, 64, 4, True),                  # the JAX kernel test's grid
    (3, 33, 50, 8, True),                  # D not a multiple of 32
])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_matches_plain(cuda, b, s, d, n, with_state,
                                         x_dtype):
    """y and the final state within 1e-4: both sides compute in float32
    from the same inputs (a bf16 x is read as the same values)."""
    args = _mamba_inputs(b, s, d, n, with_state, cuda, x_dtype, seed=s + n)
    before = mamba_kernel.launches
    y, st = mamba_kernel.mamba_scan_fwd(*args)
    torch.cuda.synchronize()
    assert mamba_kernel.launches == before + 1
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (b, s, d) and st.shape == (b, d, n)
    yp, sp = mamba_scan_ref(*args)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sp, rtol=1e-4, atol=1e-4)


def test_mamba_scan_kernel_underflow_path(cuda):
    """delta * A down to -300 / ln 2 in log2 units: the exps go through
    the special-function unit's flush to 0, and y and the state still
    match the plain version."""
    x, delta, a, bm, cm, dd, s0 = _mamba_inputs(2, 64, 256, 16, True, cuda,
                                                 torch.bfloat16, seed=5)
    delta = delta * 0 + torch.linspace(0.01, 300.0, 64, device=cuda)[
        None, :, None]
    a = -torch.ones_like(a)
    y, st = mamba_kernel.mamba_scan_fwd(x, delta, a, bm, cm, dd, s0)
    torch.cuda.synchronize()
    yp, sp = mamba_scan_ref(x, delta, a, bm, cm, dd, s0)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 100])
def test_mamba_scan_kernel_reads_bf16_operands_in_place(cuda, s):
    """The model's call: x, B, C and D in bf16, B and C strided views of
    one projection, A in float32. The wrapper allocates y and the state
    and nothing else (no float32 copies), and the result matches the plain
    version on the same values."""
    x, delta, a, _, _, dd, s0 = _mamba_inputs(2, s, 192, 16, s == 1, cuda,
                                              torch.bfloat16, seed=s)
    r = np.random.RandomState(s)
    proj = torch.tensor(r.randn(2, s, 24 + 32), dtype=torch.bfloat16,
                        device=cuda)
    bm, cm = proj[..., 24:40], proj[..., 40:]
    dd = dd.bfloat16()
    assert not bm.is_contiguous()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    y, st = mamba_kernel.mamba_scan_fwd(x, delta, a, bm, cm, dd, s0)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == before + 2
    yp, sp = mamba_scan_ref(x, delta, a, bm, cm, dd, s0)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sp, rtol=1e-4, atol=1e-4)


def test_mamba_scan_kernel_refuses_what_it_does_not_take(cuda):
    x, delta, a, bm, cm, dd, s0 = _mamba_inputs(2, 8, 64, 16, True, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mamba_kernel.mamba_scan_fwd(x.double(), delta, a, bm, cm, dd, s0)
    with pytest.raises(ValueError, match="float32"):
        mamba_kernel.mamba_scan_fwd(x, delta.bfloat16(), a, bm, cm, dd, s0)
    with pytest.raises(ValueError, match="shapes"):
        mamba_kernel.mamba_scan_fwd(x, delta, a[:32].contiguous(), bm, cm,
                                    dd, s0)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_kernel.mamba_scan_fwd(x.transpose(0, 1), delta, a, bm, cm, dd,
                                    s0)
    a_off = torch.empty(a.numel() + 1, device=cuda)[1:].view(a.shape)
    a_off.copy_(a)
    with pytest.raises(ValueError, match="a is not 16-byte aligned"):
        mamba_kernel.mamba_scan_fwd(x, delta, a_off, bm, cm, dd, s0)
    with pytest.raises(ValueError, match="d_state"):
        a12 = torch.zeros(64, 12, device=cuda)
        b12 = torch.zeros(2, 8, 12, device=cuda)
        mamba_kernel.mamba_scan_fwd(x, delta, a12, b12, b12, dd)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_kernel.mamba_scan_fwd(x.cpu(), delta, a, bm, cm, dd, s0)


def _mamba_bwd_inputs(b, s, d, n, with_state, with_gs, dtype, device,
                     seed):
    """The scan's inputs as the model hands them over (x and D in
    ``dtype``, B and C strided views of one projection in ``dtype``;
    delta, A and the state float32) and the cotangents gy and gs."""
    x, delta, a, _, _, dd, s0 = _mamba_inputs(b, s, d, n, with_state,
                                              device, dtype, seed=seed)
    r = np.random.RandomState(seed + 1)
    proj = torch.tensor(r.randn(b, s, 8 + 2 * n), dtype=dtype,
                        device=device)
    bm, cm = proj[..., 8:8 + n], proj[..., 8 + n:]
    gy = torch.tensor(r.randn(b, s, d), dtype=torch.float32, device=device)
    gs = (torch.tensor(r.randn(b, d, n), dtype=torch.float32, device=device)
          if with_gs else None)
    return (x, delta, a, bm, cm, dd.to(dtype), s0), gy, gs


@pytest.mark.parametrize("s", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 128])
@pytest.mark.parametrize("with_state,with_gs", [
    (False, False), (True, False), (False, True), (True, True)])
def test_mamba_scan_bwd_kernel_matches_plain(cuda, s, with_state, with_gs):
    """The backward kernel against the plain version's VJP
    (``mamba_scan_bwd_plain``) in fp32, around its 16-step chunks and the
    forward's 32-step tiles, with and without a state in and a state
    cotangent, over 200 channels (a ragged last block of 64), B and C
    strided views: every gradient within 5e-4 of max |plain|."""
    args, gy, gs = _mamba_bwd_inputs(2, s, 200, 16, with_state, with_gs,
                                     torch.float32, cuda, seed=s)
    before = mamba_kernel.bwd_launches
    got = mamba_kernel.mamba_scan_bwd(*args, gy, gs)[:7]
    torch.cuda.synchronize()
    assert mamba_kernel.bwd_launches == before + 1
    _grads_close(got, mamba_scan_bwd_plain(*args, gy, gs), 5e-4)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("s", [1, 100])
def test_mamba_scan_bwd_kernel_bf16_operands(cuda, n, s):
    """x, B, C and D in bf16 as the model hands them over, B and C strided
    views: dx, dB, dC and dD come back in bf16 within 1e-2 of max |plain|,
    the float32 gradients within 5e-4."""
    args, gy, gs = _mamba_bwd_inputs(2, s, 192, n, True, True,
                                     torch.bfloat16, cuda, seed=s + n)
    got = mamba_kernel.mamba_scan_bwd(*args, gy, gs)[:7]
    torch.cuda.synchronize()
    want = mamba_scan_bwd_plain(*args, gy, gs)
    bf16 = [i for i, w in enumerate(want) if w is not None
            and w.dtype == torch.bfloat16]
    assert bf16 == [0, 3, 4, 5]
    _grads_close([g for i, g in enumerate(got) if i in bf16],
                 [w for i, w in enumerate(want) if i in bf16], 1e-2)
    _grads_close([g for i, g in enumerate(got) if i not in bf16],
                 [w for i, w in enumerate(want) if i not in bf16], 5e-4)


_SCAN_BWD_BUILDS = {}


def _scan_bwd_with(p):
    """The scan's backward wrapper loaded anew with
    ``BWD_THREADS_PER_CHANNEL`` = p, so that it builds and launches its
    kernel with p threads a channel, as
    ``examples/bench_recurrent_kernels_torch.py`` builds its variants."""
    if p not in _SCAN_BWD_BUILDS:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            f"scan_bwd_p{p}", mamba_kernel.__file__)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.BWD_THREADS_PER_CHANNEL = p
        _SCAN_BWD_BUILDS[p] = mod
    return _SCAN_BWD_BUILDS[p]


@pytest.mark.parametrize("s", [15, 16, 17, 33])
@pytest.mark.parametrize("n,p", [
    (4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4), (8, 8),
    (16, 1), (16, 2), (16, 4), (16, 8)])
def test_mamba_scan_bwd_kernel_every_threads_per_channel(cuda, n, p, s):
    """The backward kernel built with each count of threads a channel
    (``BWD_THREADS_PER_CHANNEL`` 1, 2, 4, 8, capped at N) at every N,
    around its 16-step chunks, with a state in and a state cotangent, over
    200 channels (a ragged last block): every gradient within 5e-4 of
    max |plain|."""
    args, gy, gs = _mamba_bwd_inputs(2, s, 200, n, True, True,
                                     torch.float32, cuda, seed=s + n + p)
    got = _scan_bwd_with(p).mamba_scan_bwd(*args, gy, gs)[:7]
    torch.cuda.synchronize()
    _grads_close(got, mamba_scan_bwd_plain(*args, gy, gs), 5e-4)


def test_mamba_scan_bwd_kernel_at_4096_steps_full_width(cuda):
    """One sequence of 4096 steps at jamba's 8192 channels of 16 states,
    x, B, C and D in bf16 as the model hands them over: 256 chunks, dx,
    dB, dC and dD within 1e-2 of max |plain| and the float32 gradients
    within 5e-4."""
    args, gy, gs = _mamba_bwd_inputs(1, 4096, 8192, 16, False, False,
                                     torch.bfloat16, cuda, seed=13)
    got = mamba_kernel.mamba_scan_bwd(*args, gy, gs)[:7]
    torch.cuda.synchronize()
    want = mamba_scan_bwd_plain(*args, gy, gs)
    bf16 = [0, 3, 4, 5]
    _grads_close([got[i] for i in bf16], [want[i] for i in bf16], 1e-2)
    _grads_close([g for i, g in enumerate(got) if i not in bf16],
                 [w for i, w in enumerate(want) if i not in bf16], 5e-4)


def test_mamba_scan_bwd_kernel_repeats_bit_for_bit(cuda):
    """dB, dC, dA and dD are summed over channels, batch and time from
    partials in order, without atomics: two calls give the same bits."""
    args, gy, gs = _mamba_bwd_inputs(4, 100, 8192, 16, True, True,
                                     torch.bfloat16, cuda, seed=3)
    one = mamba_kernel.mamba_scan_bwd(*args, gy, gs)[:7]
    two = mamba_kernel.mamba_scan_bwd(*args, gy, gs)[:7]
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_mamba_scan_bwd_kernel_refuses_what_it_does_not_take(cuda):
    args, gy, gs = _mamba_bwd_inputs(2, 8, 64, 16, True, True,
                                     torch.float32, cuda, seed=1)
    with pytest.raises(ValueError, match="float32"):
        mamba_kernel.mamba_scan_bwd(*args, gy.bfloat16(), gs)
    with pytest.raises(ValueError, match="shapes"):
        mamba_kernel.mamba_scan_bwd(*args, gy[:, :4].contiguous(), gs)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_kernel.mamba_scan_bwd(*args, gy.transpose(0, 1).contiguous()
                                    .transpose(0, 1), gs)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_kernel.mamba_scan_bwd(*args, gy.cpu(), gs)


def test_mamba_scan_bwd_kernel_refuses_another_thread_count(cuda):
    """The kernel checks at every launch the threads a channel that the
    wrapper counts its operations with against those it was built with."""
    args, gy, gs = _mamba_bwd_inputs(2, 8, 64, 16, True, True,
                                     torch.float32, cuda, seed=1)
    mod = _scan_bwd_with(2)
    mod.build_bwd()
    mod.BWD_THREADS_PER_CHANNEL = 4
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            mod.mamba_scan_bwd(*args, gy, gs)
    finally:
        mod.BWD_THREADS_PER_CHANNEL = 2


def test_mamba_scan_op_gradient_on_the_card(cuda):
    """The op runs the kernel forward and the backward kernel back, one
    launch each; its gradients match the plain version's own, state0
    included. The loss is linear in y and the state."""
    arrays = _mamba_inputs(2, 40, 96, 16, True, cuda, seed=7)
    r = np.random.RandomState(8)
    gy = torch.tensor(r.randn(2, 40, 96), dtype=torch.float32, device=cuda)
    gs = torch.tensor(r.randn(2, 96, 16), dtype=torch.float32, device=cuda)
    ts = [a.clone().requires_grad_() for a in arrays]
    before = (mamba_kernel.launches, mamba_kernel.bwd_launches)
    y, st = mamba_scan(*ts)
    assert mamba_kernel.launches == before[0] + 1
    grads = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), ts)
    assert (mamba_kernel.launches, mamba_kernel.bwd_launches) \
        == (before[0] + 1, before[1] + 1)
    ref = [a.clone().requires_grad_() for a in arrays]
    yp, sp = mamba_scan_ref(*ref)
    want = torch.autograd.grad((yp * gy).sum() + (sp * gs).sum(), ref)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_jamba_model_runs_the_mamba_scan_kernel(cuda):
    """A tiny jamba (one period: 7 mamba layers, 1 attention, 4 MoE) on the
    card: every mamba layer's scan is one kernel launch in prefill and in
    each decode step, the attention layer's prefill one flash launch, and
    the logits agree with the plain path's (fp32, TF32 off)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import build_model

    cfg = smoke_config("jamba-v0.1-52b").with_overrides(num_layers=8)
    model = build_model(cfg, device=cuda, seed=0)
    toks = torch.as_tensor(np.random.RandomState(0).randint(1, 512, (2, 40)),
                           device=cuda)
    outs = []
    with torch.inference_mode():
        for use_kernel in (True, False):
            model.use_kernel = use_kernel
            before = (mamba_kernel.launches, flash.launches)
            logits, pre = model.prefill({"tokens": toks})
            cache = model.init_cache(2, 48, prefix=pre)
            tok = logits[:, -1].argmax(-1)[:, None]
            steps = [logits[:, -1]]
            for step in range(3):
                lg, cache = model.decode_step(cache, tok, 40 + step)
                tok = lg.argmax(-1)[:, None]
                steps.append(lg)
            assert (mamba_kernel.launches - before[0],
                    flash.launches - before[1]) == \
                ((7 * 4, 1) if use_kernel else (0, 0))
            outs.append(torch.stack(steps))
    scale = outs[1].abs().max().item()
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4,
                               atol=1e-5 * scale)


def test_ds2_on_the_card_matches_the_cpu(cuda):
    """A small DS2 at SL 100 (odd T' with the SAME pads): the card's loss
    within rtol 1e-5 and every gradient within 1e-4 of max |cpu|."""
    from repro_torch.models.rnn import DS2, DS2Config

    cfg = DS2Config(num_freq=161, conv_channels=8, d_h=64, num_gru=2)
    card = DS2(cfg, seed=0, device=cuda)
    host = DS2(cfg, seed=0, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    out = []
    for model in (card, host):
        names, params = zip(*model.named_parameters())
        loss, _ = model.loss(model.make_batch(3, 4, 100))
        out.append((loss.item(), [g.cpu() for g in
                                  torch.autograd.grad(loss, params)]))
    (loss_c, grads_c), (loss_h, grads_h) = out
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    for name, gc_, gh in zip(names, grads_c, grads_h):
        rel = ((gc_ - gh).abs().max() / gh.abs().max()).item()
        assert rel <= 1e-4, (name, rel)


def test_counting_pass_on_the_card(cuda):
    """Track A's counts of a GNMT step on the card equal the CPU's with the
    plain cell. With the kernel, a dispatcher op with a registered
    operation count (``lstm_cell_flops``: the gate GEMM's 2 B K 4H, as the
    plain cell's matmul counts it, and B 4H for the bias), the counting
    pass sees every cell: B 4H more a timestep and no matmul of its own.
    The counting pass runs the plain cell, which is what the reference
    counts."""
    from repro_torch.core.characterize import count_costs
    from repro_torch.models.rnn import GNMT, GNMTConfig

    cfg = GNMTConfig(vocab_size=256, d_model=32, num_enc_uni=1, num_dec=2)
    counts = {}
    for dev, use_kernel in ((cuda, False), ("cpu", False), (cuda, True)):
        model = GNMT(cfg, seed=0, device=dev)
        batch = model.make_batch(0, 4, 9, 9)
        counts[str(dev), use_kernel] = count_costs(
            lambda: model.loss(batch, use_kernel=use_kernel))
    plain = counts["cuda", False]
    assert plain == counts["cpu", False]
    with_kernel = counts["cuda", True]
    extra = with_kernel[0] - plain[0]
    bias = 4 * 4 * cfg.d_model                 # B 4H a cell, batch 4
    assert extra > 0 and extra % bias == 0, (extra, bias)
    assert not any(k.startswith("bmm:f32[1,4,") for k in with_kernel[2])


# ---------------------------------------------------------------------------
# the training path on the card (chip_smoke.py's training phases, small)


def _train_run(head_dim=32, **kw):
    from repro_torch.configs import (
        MeshConfig,
        OptimizerConfig,
        RunConfig,
        ShapeConfig,
        StepKind,
        smoke_config,
    )
    cfg = smoke_config("starcoder2-3b").with_overrides(
        num_layers=2, d_model=64 if head_dim == 32 else 256, d_ff=128,
        vocab_size=256, head_dim=head_dim)
    return cfg, RunConfig(
        model=cfg, shape=ShapeConfig("tiny", seq_len=32, global_batch=8,
                                     step=StepKind.TRAIN),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2), **kw)


def _trainer(cfg, run, device, ckpt_dir=None, timer=None):
    import time

    from repro_torch.data.batching import DataIterator
    from repro_torch.data.synthetic import IWSLT_LIKE
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import Runtime
    from repro_torch.resilience.recovery import RecoveryPolicy
    from repro_torch.train.trainer import Trainer
    model = build_model(cfg, Runtime.from_run(run), device=device, seed=0)
    data = DataIterator(IWSLT_LIKE, samples_per_epoch=256, batch_size=8,
                        vocab_size=cfg.vocab_size, granularity=8, seed=1)
    return Trainer(model, run, data, ckpt_dir=ckpt_dir, ckpt_every=4,
                   total_steps=16, timer=timer or time.perf_counter,
                   policy=RecoveryPolicy(backoff_base_s=0.0))


def test_trainer_runs_flash_on_the_tensor_cores_every_layer_and_step(cuda):
    """bf16 at head_dim 128 (the reference RunConfig's dtypes): one flash
    launch per attention layer per step, all on the tensor-core path, and
    the losses finite; the step synchronizes inside its span."""
    from repro_torch.obs import trace
    cfg, run = _train_run(head_dim=128)
    tr = _trainer(cfg, run, cuda)
    for attr in ("launches", "launches_tc", "launches_simt", "bwd_launches",
                 "bwd_launches_tc"):
        setattr(flash, attr, 0)
    trace.get_tracer().clear()
    trace.enable_tracing(True)
    try:
        rep = tr.train(5)
    finally:
        trace.enable_tracing(False)
    assert flash.launches == flash.launches_tc == 2 * 5
    assert flash.bwd_launches == flash.bwd_launches_tc == 2 * 5
    assert all(np.isfinite(rep.losses))
    names = [e["name"] for e in trace.get_tracer().events]
    assert names.count("train/block_until_ready") == 5


def test_train_step_with_the_kernel_matches_the_plain_path(cuda):
    """fp32 (CUDA-core flash): three steps with the kernel and without,
    from the same weights and batches: losses, grad norms and the updated
    parameters within 1e-4 of max |plain|."""
    from repro_torch.train.train_step import build_train_step, \
        init_train_state
    cfg, run = _train_run(param_dtype="float32", compute_dtype="float32")
    tr = _trainer(cfg, run, cuda)
    init = {k: v.clone() for k, v in tr.model.state_dict().items()}
    it = iter(tr.data)
    batches = [next(it)[:2] for _ in range(3)]
    out = {}
    for use_kernel in (True, False):
        tr.model.load_state_dict(init)
        tr.model.use_kernel = use_kernel
        state = init_train_state(tr.model, run)
        step = build_train_step(tr.model, run, 16)
        ms = [step(state, tr._batch(t, lab))[1] for t, lab in batches]
        out[use_kernel] = ([float(m["loss"]) for m in ms],
                           [float(m["grad_norm"]) for m in ms],
                           {k: v.detach().clone()
                            for k, v in state.params.items()})
    (lk, gk, pk), (lp, gp, pp) = out[True], out[False]
    np.testing.assert_allclose(lk, lp, rtol=1e-4)
    np.testing.assert_allclose(gk, gp, rtol=1e-4)
    for name in pp:
        rel = ((pk[name] - pp[name]).abs().max()
               / pp[name].abs().max()).item()
        assert rel <= 1e-4, (name, rel)


def test_checkpoint_round_trips_card_tensors(cuda, tmp_path):
    """bf16 and fp32 leaves on the card come back on the card, bit for
    bit; save_async's snapshot is taken before it returns."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    x = torch.randn(64, 33, device=cuda).to(torch.bfloat16)
    y = torch.randn(7, device=cuda)
    want = (x.clone(), y.clone())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"x": x, "y": y})
    x.add_(1.0)
    mgr.wait()
    got, _ = mgr.restore({"x": torch.zeros_like(x), "y": torch.zeros_like(y)})
    assert got["x"].is_cuda and got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got["y"], want[1])


def test_preemption_resume_on_the_card_matches_a_fault_free_run(cuda,
                                                                tmp_path):
    """fp32 under a FakeClock: preempted at step 6 and resumed by a fresh
    Trainer, the run logs the fault-free run's SLs and runtimes and its
    losses within rtol 1e-5 (a nondeterministic op would show here)."""
    from repro_torch.resilience import faults
    from repro_torch.resilience.faults import FaultPlan

    class FakeClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 1.0
            return self.t

    cfg, run = _train_run(param_dtype="float32", compute_dtype="float32")
    ref = _trainer(cfg, run, cuda, str(tmp_path / "ref"), FakeClock())
    ref_rep = ref.train(10)
    faults.install(FaultPlan.parse("preempt@6"))
    try:
        rep = _trainer(cfg, run, cuda, str(tmp_path / "ck"),
                       FakeClock()).train(10)
    finally:
        faults.install(None)
    tr = _trainer(cfg, run, cuda, str(tmp_path / "ck"), FakeClock())
    rep2 = tr.train(10 - rep.steps)
    assert rep.preempted and rep2.resumed_from == 6
    np.testing.assert_allclose(rep.losses + rep2.losses, ref_rep.losses,
                               rtol=1e-5)
    assert tr.epoch_log.to_jsonable() == ref.epoch_log.to_jsonable()


# ---------------------------------------------------------------------------
# the distribution slice on the card: a one-rank NCCL mesh and remat


def test_one_rank_nccl_mesh_prefill_matches_the_plain_model(cuda, tmp_path):
    """starcoder2-3b at full width and 2 layers in bf16, its parameters
    DTensors on a 1 x 1 ("data", "model") NCCL mesh by ``param_specs``:
    the prefill's logits equal the plain model's (tol 1e-3 of max
    |plain|), through 2 flash launches on the tensor cores."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import MeshConfig, get_model_config
    from repro_torch.dist import sharding
    from repro_torch.dist.axes import placements, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import BF16

    cfg = get_model_config("starcoder2-3b").with_overrides(num_layers=2)
    model = build_model(cfg, BF16, device=cuda, seed=0)
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 256)), device=cuda)
    with torch.no_grad():
        want = model.prefill({"tokens": toks})[0].float()
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mcfg = MeshConfig(shape=(1, 1), axes=("data", "model"))
        mesh = make_mesh(mcfg)
        sharding.distribute_params(model, mesh,
                                   sharding.param_specs(model, cfg, mcfg))
        tok = distribute_tensor(toks, mesh, placements(("data", None), mesh))
        for attr in ("launches", "launches_tc", "launches_simt"):
            setattr(flash, attr, 0)
        with torch.no_grad(), use_mesh(mesh):
            got = model.prefill({"tokens": tok})[0].full_tensor().float()
        assert flash.launches == flash.launches_tc == 2
    finally:
        dist.destroy_process_group()
    assert float((got - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


def test_remat_modes_give_the_same_losses_on_the_card(cuda):
    """starcoder2-3b at full width and 2 layers, bf16 with fp32 moments:
    three train steps under each remat mode from the same weights and
    batches give losses within 1e-3 of "none"'s; the checkpointed forward
    runs again in the backward (twice the flash launches)."""
    import dataclasses

    from repro_torch.configs import (
        MeshConfig,
        OptimizerConfig,
        RunConfig,
        ShapeConfig,
        StepKind,
        get_model_config,
    )
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.train_step import build_train_step, \
        init_train_state

    cfg = get_model_config("starcoder2-3b").with_overrides(num_layers=2)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "t", seq_len=256, global_batch=4, step=StepKind.TRAIN),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        optimizer=OptimizerConfig(lr=3e-4, warmup_steps=1))
    model = build_model(cfg, Runtime.from_run(run), device=cuda, seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    r = np.random.RandomState(2)
    batches = [{k: torch.as_tensor(r.randint(0, cfg.vocab_size, (4, 256)),
                                   device=cuda)
                for k in ("tokens", "labels")} for _ in range(3)]
    losses = {}
    for mode in ("none", "block", "save_boundaries"):
        model.load_state_dict(init)
        model.rt = dataclasses.replace(model.rt, remat=mode)
        state = init_train_state(model, run)
        step = build_train_step(model, run, 3)
        flash.launches = flash.bwd_launches = 0
        losses[mode] = [float(step(state, b)[1]["loss"]) for b in batches]
        assert flash.launches == (1 if mode == "none" else 2) * 2 * 3
        assert flash.bwd_launches == 2 * 3
    for mode in ("block", "save_boundaries"):
        np.testing.assert_allclose(losses[mode], losses["none"], rtol=1e-3)
