"""The LSTM cell with its gradient, and the whole-sequence runner built on it.

Each timestep runs the Hopper kernels for CUDA tensors and the plain
versions (``ref.py``) for CPU tensors, forward and backward; there is no
fallback from one to the other. The JAX package has no VJP for its kernel
(GNMT's gradients there come from XLA autodiff of ``lax.scan`` over the
plain cell); here the backward of a step is a kernel of its own
(``csrc/lstm_cell_bwd.cu``): from the preactivations ``z`` the forward
saved it forms ``dz``, ``dc_prev`` and ``dxh = dz W^T``. ``dW = XH^T dZ``
and ``db`` are one product and one sum over a whole sequence's rows
(``LSTMSequenceFunction``), fp32 as the matmul runs with TF32 off.

Both kernels are ops (``torch.library`` definitions: their dispatch costs a
few microseconds a call, where a ``custom_op``'s Python wrapper costs about
20), so that a fake-tensor trace follows them:

* ``repro_torch::lstm_cell_fwd`` writes (h, c) and, where given, z into
  its out arguments (h to rows of any stride, so a sequence writes it into
  the next step's [x; h] row); its fake counts ``kernel.fake_calls`` and
  ``FlopCounterMode`` counts ``lstm_cell_flops``;
* ``repro_torch::lstm_cell_bwd`` returns (dz, dxh, dc_prev); its fake
  counts ``kernel.bwd_fake_calls`` and ``FlopCounterMode`` counts
  ``lstm_cell_bwd_flops``.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ref import (
    lstm_cell_bwd_plain,
    lstm_cell_fwd_plain,
    lstm_cell_ref,
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


_LIB.define("lstm_cell_bwd(Tensor z, Tensor c, Tensor w, Tensor dh, "
            "Tensor dc, Tensor? dh_up) -> (Tensor, Tensor, Tensor)")
_LIB.impl("lstm_cell_bwd", kernel.lstm_cell_bwd, "CUDA")


@torch.library.register_fake("repro_torch::lstm_cell_bwd")
def _fake_bwd(z, c, w, dh, dc, dh_up):
    kernel.bwd_fake_calls += 1
    return (z.new_empty(z.shape), z.new_empty((z.shape[0], w.shape[0])),
            c.new_empty(c.shape))


def lstm_cell_bwd_flops(b: int, k: int, h: int) -> int:
    """``dxh = dz W^T``'s 2 * B * K * 4H, the count the card's bound takes
    (the gate math's B * H terms are left out, as the forward leaves its
    own out)."""
    return 2 * b * k * 4 * h


@register_flop_formula(torch.ops.repro_torch.lstm_cell_bwd)
def _bwd_flops(z_shape, c_shape, w_shape, *args, **kwargs) -> int:
    return lstm_cell_bwd_flops(z_shape[0], w_shape[0], w_shape[1])


_FWD = torch.ops.repro_torch.lstm_cell_fwd.default
_BWD = torch.ops.repro_torch.lstm_cell_bwd.default


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


def _cell_bwd(z, c, w, dh, dc, dh_up=None):
    """One step's (dz, dxh, dc_prev)."""
    if z.is_cuda:
        return _BWD(z, c, w, dh, dc, dh_up)
    if z.device.type == "cpu":
        return lstm_cell_bwd_plain(z, c, w, dh, dc, dh_up)
    raise ValueError(f"lstm_cell: no kernel for device {z.device}")


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
        xh, w, c, z = ctx.saved_tensors
        dz, dxh, dc_prev = _cell_bwd(z, c, w, dh.contiguous(),
                                     dc.contiguous())
        dw, db = _weight_grads(xh, dz, w)
        return dxh, dw, db, dc_prev


def lstm_cell(xh, w, b, c):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H) -> (h, c)."""
    return LSTMCellFunction.apply(xh, w, b, c)


class LSTMSequenceFunction(torch.autograd.Function):
    """A whole layer: (xs (B, S, D), h0, c0 (B, H), w, b, reverse,
    need_grad) -> hs (B, S, H), one cell launch a step and, in the
    backward, one backward launch a step.

    The forward copies xs once into a (S + 1, B, D+H) buffer in step order
    (time reversed under ``reverse``), each step reading row j and writing
    its h into row j + 1's tail: no per-step concatenation. With
    ``need_grad`` it saves that buffer, the c's and the z's. The backward
    walks the steps in reverse, h's cotangent being the next step's dxh
    tail plus the layer's own (added inside the backward op), and ends
    with one dW = XH^T dZ over all S·B rows and one db."""

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
        # the layer's own cotangents, a (B, H) row a time; step j runs at
        # time times[j]
        g = dhs.transpose(0, 1).contiguous().unbind(0)
        times = range(s - 1, -1, -1) if ctx.reverse else range(s)
        z_rows, c_rows = zs.unbind(0), cs.unbind(0)
        dzs, dxs = [None] * s, [None] * s
        dh, dh_up, dc = g[times[s - 1]], None, torch.zeros_like(c_rows[0])
        for j in range(s - 1, -1, -1):
            dzs[j], dxh, dc = _cell_bwd(z_rows[j], c_rows[j], w, dh, dc,
                                        dh_up)
            # h's cotangent for the step before: this dxh's tail, and the
            # layer's own share at its time
            dxs[times[j]], dh = dxh.split((d, h), dim=1)
            dh_up = g[times[j - 1]] if j else None
        need = ctx.needs_input_grad
        dw = db = None
        if need[3] or need[4]:
            dw, db = _weight_grads(xh[:s].reshape(s * bsz, d + h),
                                   torch.stack(dzs), w)
        return (torch.stack(dxs, dim=1) if need[0] else None,
                dh if need[1] else None, dc if need[2] else None,
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
