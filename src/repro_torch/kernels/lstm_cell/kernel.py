"""Launch the hand-written Hopper LSTM-cell kernels (``csrc/lstm_cell.cu``
and its gradient, ``csrc/lstm_cell_bwd.cu``).

The forward source replaces the Pallas TPU kernel
``src/repro/kernels/lstm_cell/kernel.py::lstm_cell_fwd``; its header states
the design and the bound. It can also write the step's gate
preactivations z, which the backward reads, and its h to rows of any
stride (a sequence's next [x; h] row). The backward replaces no Pallas
kernel: the JAX package differentiates the plain cell by XLA's autodiff;
its header states the design. Each is built with nvcc at first use (or by
``build()`` / ``build_bwd()``) and bound with ctypes. ``launches`` and
``bwd_launches`` count every launch, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "lstm_cell.cu")
SOURCE_BWD = os.path.join(os.path.dirname(__file__), "csrc",
                          "lstm_cell_bwd.cu")

launches = 0
bwd_launches = 0
# calls a fake-tensor trace made through the ops (``ops.py``): what a
# traced step would launch; never a launch
fake_calls = 0
bwd_fake_calls = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("lstm_cell", (SOURCE,))
    fn = lib.lstm_cell_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def build_bwd() -> ctypes.CDLL:
    """Compile (once) and load the backward kernel's library."""
    lib = _build.load("lstm_cell_bwd", (SOURCE_BWD,))
    fn = lib.lstm_cell_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(what: str, named, shapes, rows=()) -> None:
    """Each of ``named`` ((name, tensor or None), ...) on the first one's
    CUDA device, float32, of its shape in ``shapes``, and contiguous but
    for the names in ``rows``, which need unit stride along their last
    axis only. Runs once per timestep of every LSTM layer: device and type
    are compared as an int and by identity, the cheap way."""
    dev = named[0][1].get_device()
    for (name, t), shape in zip(named, shapes):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not on a "
                             "CUDA device")
        if t.get_device() != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"{named[0][0]} on {named[0][1].device}")
        if t.dtype is not torch.float32:
            raise ValueError(f"{what}: {name} is {t.dtype}; the kernel "
                             "takes float32")
        if t.shape != shape:
            raise ValueError(f"{what}: shapes disagree: {name} is "
                             f"{tuple(t.shape)}, want {shape}")
        if name in rows:
            if t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f"{what}: {name}'s rows are not "
                                 "contiguous")
        elif not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _launch(dev: int, fn, *args) -> int:
    """``fn(*args, stream)``: a C entry point called on CUDA device ``dev``
    (made current for the call where it is not) with that device's current
    stream, read as a raw pointer: ``torch.cuda.current_stream()`` builds a
    Stream object on every call, which the per-step launches feel."""
    if torch._C._cuda_getDevice() != dev:
        with torch.cuda.device(dev):
            return _launch(dev, fn, *args)
    return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


def _aligned(what: str, *named) -> None:
    for name, t in named:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def lstm_cell_fwd(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, h_out: Optional[torch.Tensor] = None,
                  c_out: Optional[torch.Tensor] = None,
                  z_out: Optional[torch.Tensor] = None):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H), all contiguous
    float32 on one CUDA device. Writes h_new into ``h_out`` (B, H; its rows
    may be any stride apart, e.g. a view of the next step's xh), c_new into
    ``c_out`` (B, H), each allocated where None, and the gate
    preactivations z = xh W + b into ``z_out`` (B, H, 4) where one is
    given. Returns (h_out, c_out)."""
    global launches
    what = "lstm_cell kernel"
    if xh.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{what}: want xh (B, K), w (K, H, 4); got "
                         f"{tuple(xh.shape)}, {tuple(w.shape)}")
    bsz, k, h = xh.shape[0], xh.shape[1], w.shape[1]
    if bsz == 0 or k == 0 or h == 0:
        raise ValueError(f"{what}: empty input")
    if h_out is None:
        h_out = torch.empty_like(c)
    if c_out is None:
        c_out = torch.empty_like(c)
    _check(what, (("xh", xh), ("w", w), ("b", b), ("c", c), ("h_out", h_out),
                  ("c_out", c_out), ("z_out", z_out)),
           ((bsz, k), (k, h, 4), (h, 4), (bsz, h), (bsz, h), (bsz, h),
            (bsz, h, 4)), rows=("h_out",))
    _aligned(what, ("w", w), ("b", b), ("z_out", z_out))
    err = _launch(xh.get_device(), build().lstm_cell_fwd,
                  xh.data_ptr(), w.data_ptr(), b.data_ptr(), c.data_ptr(),
                  h_out.data_ptr(), c_out.data_ptr(),
                  None if z_out is None else z_out.data_ptr(), bsz, k, h,
                  h_out.stride(0))
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error {err}")
    launches += 1
    return h_out, c_out


def lstm_cell_bwd(z: torch.Tensor, c: torch.Tensor, w: torch.Tensor,
                  dh: torch.Tensor, dc: torch.Tensor,
                  dh_up: Optional[torch.Tensor] = None):
    """One timestep's gradient (``ref.py::lstm_cell_bwd_plain``): z (B, H,
    4) the saved preactivations, c (B, H) the state the step started from,
    w (D+H, H, 4), dh (B, H) h_new's cotangent (rows of any stride, e.g.
    the tail of the next step's dxh), dc (B, H) c_new's, dh_up (B, H) or
    None a second share of h_new's; float32 on one CUDA device, all but dh
    contiguous. Returns (dz (B, H, 4), dxh (B, D+H), dc_prev (B, H))."""
    global bwd_launches
    what = "lstm_cell backward kernel"
    if z.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{what}: want z (B, H, 4), w (K, H, 4); got "
                         f"{tuple(z.shape)}, {tuple(w.shape)}")
    bsz, h, k = z.shape[0], z.shape[1], w.shape[0]
    if bsz == 0 or k == 0 or h == 0:
        raise ValueError(f"{what}: empty input")
    _check(what, (("z", z), ("c", c), ("w", w), ("dh", dh), ("dc", dc),
                  ("dh_up", dh_up)),
           ((bsz, h, 4), (bsz, h), (k, h, 4), (bsz, h), (bsz, h), (bsz, h)),
           rows=("dh",))
    _aligned(what, ("z", z), ("w", w))
    dz = torch.empty_like(z)
    dxh = z.new_empty((bsz, k))
    dc_prev = torch.empty_like(c)
    err = _launch(z.get_device(), build_bwd().lstm_cell_bwd,
                  z.data_ptr(), c.data_ptr(), w.data_ptr(), dh.data_ptr(),
                  dh.stride(0), None if dh_up is None else dh_up.data_ptr(),
                  dc.data_ptr(), dz.data_ptr(), dxh.data_ptr(),
                  dc_prev.data_ptr(), bsz, k, h)
    if err != 0:
        raise RuntimeError(f"lstm_cell backward kernel launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    return dz, dxh, dc_prev
