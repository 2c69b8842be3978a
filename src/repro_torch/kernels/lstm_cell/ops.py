"""The LSTM cell with its gradient, and the whole-sequence runner built on it.

The kernels run for CUDA tensors and the plain versions (``ref.py``) for
CPU tensors, forward and backward; there is no fallback from one to the
other. The JAX package has no VJP for its kernel (GNMT's gradients there
come from XLA autodiff of ``lax.scan`` over the plain cell); here the
forward launches the cell a step, and the backward of a whole layer is one
launch of a kernel of its own (``csrc/lstm_seq_bwd.cu``): from the
preactivations z the forward saved it walks the steps backward, forming
every step's dz, and h0's and c0's cotangents, through the recurrent rows
W_h = w[D:] alone. The products that carry nothing from step to step, dX =
dZ W_x^T, dW = XH^T dZ and db, are one product or sum each over all of a
layer's rows (``LSTMSequenceFunction``), fp32 as the matmul runs with TF32
off.

Both kernels are ops (``torch.library`` definitions: their dispatch costs a
few microseconds a call, where a ``custom_op``'s Python wrapper costs about
20), so that a fake-tensor trace follows them:

* ``repro_torch::lstm_cell_fwd`` writes (h, c) and, where given, z into
  its out arguments (h to rows of any stride, so a sequence writes it into
  the next step's [x; h] row); its fake counts ``kernel.fake_calls`` and
  ``FlopCounterMode`` counts ``lstm_cell_flops``;
* ``repro_torch::lstm_seq_bwd`` returns (dzs, dh0, dc0); its fake counts
  ``kernel.bwd_fake_calls`` and ``FlopCounterMode`` counts
  ``lstm_seq_bwd_flops``.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ref import (
    lstm_cell_fwd_plain,
    lstm_cell_ref,
    lstm_seq_bwd_plain,
)

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("lstm_cell_fwd(Tensor xh, Tensor w, Tensor b, Tensor c, "
            "Tensor(a!) h_out, Tensor(b!) c_out, Tensor(c!)? z_out) -> ()")


def _fwd_cuda(xh, w, b, c, h_out, c_out, z_out):
    kernel.lstm_cell_fwd(xh, w, b, c, h_out, c_out, z_out)


_LIB.impl("lstm_cell_fwd", _fwd_cuda, "CUDA")


@torch.library.register_fake("repro_torch::lstm_cell_fwd")
def _fake(xh, w, b, c, h_out, c_out, z_out):
    kernel.fake_calls += 1


def lstm_cell_flops(b: int, k: int, h: int) -> int:
    """The gate GEMM's 2 * B * K * 4H and the bias's B * 4H, the count
    the card's bound takes."""
    return 2 * b * k * 4 * h + b * 4 * h


@register_flop_formula(torch.ops.repro_torch.lstm_cell_fwd)
def _flops(xh_shape, w_shape, *args, **kwargs) -> int:
    return lstm_cell_flops(xh_shape[0], xh_shape[1], w_shape[1])


_LIB.define("lstm_seq_bwd(Tensor zs, Tensor cs, Tensor w, Tensor g, "
            "Tensor? dc) -> (Tensor, Tensor, Tensor)")
_LIB.impl("lstm_seq_bwd", kernel.lstm_seq_bwd, "CUDA")


@torch.library.register_fake("repro_torch::lstm_seq_bwd")
def _fake_bwd(zs, cs, w, g, dc):
    kernel.bwd_fake_calls += 1
    bsz, h = zs.shape[1], zs.shape[2]
    return (zs.new_empty(zs.shape), zs.new_empty((bsz, h)),
            zs.new_empty((bsz, h)))


def lstm_seq_bwd_flops(s: int, b: int, h: int) -> int:
    """The walk's carries ``dz_t W_h^T``, 2 * B * H * 4H a step, the count
    the card's bound takes (the gate math's B * H terms are left out, as
    the forward leaves its own out). With dX = dZ W_x^T's 2 * S * B * 4H *
    D, a layer's backward counts S steps of 2 * B * (D+H) * 4H besides
    dW."""
    return 2 * s * b * h * 4 * h


@register_flop_formula(torch.ops.repro_torch.lstm_seq_bwd)
def _bwd_flops(zs_shape, *args, **kwargs) -> int:
    return lstm_seq_bwd_flops(zs_shape[0], zs_shape[1], zs_shape[2])


_FWD = torch.ops.repro_torch.lstm_cell_fwd.default
_BWD = torch.ops.repro_torch.lstm_seq_bwd.default


def _cell_fwd(xh, w, b, c, h_out=None, c_out=None, z_out=None):
    """One step: (h, c), written into ``h_out`` and ``c_out`` where given,
    and the preactivations into ``z_out`` where given."""
    if xh.is_cuda:
        h_out = torch.empty_like(c) if h_out is None else h_out
        c_out = torch.empty_like(c) if c_out is None else c_out
        _FWD(xh, w, b, c, h_out, c_out, z_out)
        return h_out, c_out
    if xh.device.type == "cpu":
        new = lstm_cell_fwd_plain(xh, w, b, c)
        outs = (h_out, c_out, z_out)
        for out, t in zip(outs, new):
            if out is not None:
                out.copy_(t)
        return tuple(t if out is None else out
                     for out, t in zip(outs[:2], new[:2]))
    raise ValueError(f"lstm_cell: no kernel for device {xh.device}")


def _seq_bwd(zs, cs, w, g, dc=None):
    """A layer's backward walk: (dzs, dh0, dc0)."""
    if zs.is_cuda:
        return _BWD(zs, cs, w, g, dc)
    if zs.device.type == "cpu":
        return lstm_seq_bwd_plain(zs, cs, w, g, dc)
    raise ValueError(f"lstm_cell: no kernel for device {zs.device}")


def _input_grads(dz, w):
    """dX = dZ W_x^T over all rows of dz (N, H, 4): (N, D)."""
    k, h, _ = w.shape
    d = k - h
    return dz.reshape(-1, 4 * h) @ w[:d].reshape(d, 4 * h).T


def _weight_grads(xh, dz, w):
    """dW = xh^T dz (xh (N, K), dz (N, H, 4)) and db = sum of dz's rows:
    one product over every row of a step or a sequence."""
    k, h, _ = w.shape
    dz2 = dz.reshape(-1, 4 * h)
    return (xh.T @ dz2).reshape(k, h, 4), dz2.sum(0).reshape(h, 4)


class LSTMCellFunction(torch.autograd.Function):
    """One timestep: (xh, w, b, c) -> (h_new, c_new), kernel layout."""

    @staticmethod
    def forward(ctx, xh, w, b, c):
        z = xh.new_empty((xh.shape[0], w.shape[1], 4))
        h_new, c_new = _cell_fwd(xh, w, b, c, z_out=z)
        ctx.save_for_backward(xh, w, c, z)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh, dc):
        """The walk at S = 1, c_new's cotangent as its last dc."""
        xh, w, c, z = ctx.saved_tensors
        dzs, dh_prev, dc_prev = _seq_bwd(
            z[None], torch.stack((c, c)), w, dh.contiguous()[None],
            dc.contiguous())
        dxh = torch.cat((_input_grads(dzs[0], w), dh_prev), dim=1)
        dw, db = _weight_grads(xh, dzs[0], w)
        return dxh, dw, db, dc_prev


def lstm_cell(xh, w, b, c):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H) -> (h, c)."""
    return LSTMCellFunction.apply(xh, w, b, c)


class LSTMSequenceFunction(torch.autograd.Function):
    """A whole layer: (xs (B, S, D), h0, c0 (B, H), w, b, reverse,
    need_grad) -> hs (B, S, H), one cell launch a step and, in the
    backward, one launch of the walk.

    The forward copies xs once into a (S + 1, B, D+H) buffer in step order
    (time reversed under ``reverse``), each step reading row j and writing
    its h into row j + 1's tail: no per-step concatenation. With
    ``need_grad`` it saves that buffer, the c's and the z's. The backward
    hands the walk the layer's own cotangents in step order, then forms
    dX = dZ W_x^T, dW = XH^T dZ and db over all S·B rows at once and puts
    dX back in time order."""

    @staticmethod
    def forward(ctx, xs, h0, c0, w, b, reverse, need_grad):
        bsz, s, d = xs.shape
        h = w.shape[1]
        xh = xs.new_empty((s + 1, bsz, d + h))
        xh[:s, :, :d] = (xs.flip(1) if reverse else xs).transpose(0, 1)
        xh[0, :, d:] = h0
        cs = xs.new_empty((s + 1, bsz, h))
        cs[0] = c0
        zs = xs.new_empty((s, bsz, h, 4)) if need_grad else None
        # every step's views at once: an unbind costs the host less a row
        # than an index a step
        rows, h_rows, c_rows = (xh.unbind(0), xh[1:, :, d:].unbind(0),
                                cs.unbind(0))
        z_rows = [None] * s if zs is None else zs.unbind(0)
        for j in range(s):
            _cell_fwd(rows[j], w, b, c_rows[j], h_rows[j], c_rows[j + 1],
                      z_rows[j])
        if need_grad:
            ctx.save_for_backward(xh, cs, zs, w)
            ctx.reverse = reverse
        hs = xh[1:, :, d:]
        return (hs.flip(0) if reverse else hs).transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, dhs):
        xh, cs, zs, w = ctx.saved_tensors
        s, bsz, h, _ = zs.shape
        d = xh.shape[2] - h
        # the layer's own cotangents in step order: step j runs at time j,
        # or at s - 1 - j under ``reverse``
        g = dhs.transpose(0, 1)
        g = (g.flip(0) if ctx.reverse else g).contiguous()
        dzs, dh0, dc0 = _seq_bwd(zs, cs, w, g)
        need = ctx.needs_input_grad
        dxs = dw = db = None
        if need[0]:
            dx = _input_grads(dzs, w).reshape(s, bsz, d)
            dxs = (dx.flip(0) if ctx.reverse else dx).transpose(0, 1)
        if need[3] or need[4]:
            dw, db = _weight_grads(xh[:s].reshape(s * bsz, d + h), dzs, w)
        return (dxs, dh0 if need[1] else None, dc0 if need[2] else None,
                dw, db, None, None)


def lstm_sequence(xs, h0, c0, w, b, reverse: bool = False,
                  use_kernel: bool = True):
    """xs: (B, S, D) -> hidden states (B, S, H). With ``reverse`` the scan
    runs t = S-1 ... 0 and keeps each output at its own time index, as
    ``lax.scan(..., reverse=True)`` does. ``use_kernel=False`` runs the plain
    cell under autograd instead, on any device, to compare against."""
    if use_kernel:
        need_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, h0, c0, w, b))
        return LSTMSequenceFunction.apply(xs, h0, c0, w, b, reverse,
                                          need_grad)
    steps = range(xs.shape[1] - 1, -1, -1) if reverse else range(xs.shape[1])
    h, c = h0, c0
    hs = [None] * xs.shape[1]
    for t in steps:
        h, c = lstm_cell_ref(torch.cat([xs[:, t], h], dim=-1), w, b, c)
        hs[t] = h
    return torch.stack(hs, dim=1)
