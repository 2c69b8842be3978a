"""Launch the hand-written Hopper LSTM kernels: the cell
(``csrc/lstm_cell.cu``) and the backward walk of a whole layer
(``csrc/lstm_seq_bwd.cu``).

The forward source replaces the Pallas TPU kernel
``src/repro/kernels/lstm_cell/kernel.py::lstm_cell_fwd``; its header states
the design and the bound. It can also write the step's gate
preactivations z, which the backward reads, and its h to rows of any
stride (a sequence's next [x; h] row). The backward replaces no Pallas
kernel: the JAX package differentiates the plain cell by XLA's autodiff of
a scan; one persistent launch walks a layer's steps backward, and its
header states the design. Each is built with nvcc at first use (or by
``build()`` / ``build_bwd()``) and bound with ctypes. ``launches`` (one a
step) and ``bwd_launches`` (one a layer's walk) count every launch, so a
run can show that its path went through the kernels.
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
                          "lstm_seq_bwd.cu")

# the walk's partition (``csrc/lstm_seq_bwd.cu``): a block owns
# ``walk_units`` hidden units; in its product WALK_GROUP threads take
# WALK_ROWS batch rows, and a group's thread ``tg`` the units tg,
# tg + WALK_GROUP, ... of each step's dz, each carry summed over a warp's
# lanes by a butterfly and over a group's warps in order
WALK_GROUP = 128
WALK_ROWS = 8

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
    """Compile (once) and load the backward walk's library."""
    lib = _build.load("lstm_seq_bwd", (SOURCE_BWD,))
    fn = lib.lstm_seq_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def walk_units(h: int, sms: int) -> int:
    """Hidden units a block of the walk owns: one block an SM at most."""
    return -(-h // sms)


@functools.lru_cache(maxsize=None)
def _sms(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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


def lstm_seq_bwd(zs: torch.Tensor, cs: torch.Tensor, w: torch.Tensor,
                 g: torch.Tensor, dc: Optional[torch.Tensor] = None):
    """A layer's backward walk (``ref.py::lstm_seq_bwd_plain``), one launch:
    zs (S, B, H, 4) the saved preactivations in step order, cs (S+1, B, H)
    the c's (cs[t] the state step t started from), w (D+H, H, 4) of which
    the walk reads the recurrent rows w[D:], g (S, B, H) the layer's own
    cotangents of h in step order, dc (B, H) or None the cotangent of the
    last step's c; float32, contiguous, on one CUDA device. Returns (dzs
    (S, B, H, 4), dh0 (B, H), dc0 (B, H))."""
    global bwd_launches
    what = "lstm_seq_bwd kernel"
    if zs.dim() != 4 or w.dim() != 3:
        raise ValueError(f"{what}: want zs (S, B, H, 4), w (K, H, 4); got "
                         f"{tuple(zs.shape)}, {tuple(w.shape)}")
    s, bsz, h, k = zs.shape[0], zs.shape[1], zs.shape[2], w.shape[0]
    if s == 0 or bsz == 0 or h == 0 or k < h:
        raise ValueError(f"{what}: empty input or w shorter than H rows")
    _check(what, (("zs", zs), ("cs", cs), ("w", w), ("g", g), ("dc", dc)),
           ((s, bsz, h, 4), (s + 1, bsz, h), (k, h, 4), (s, bsz, h),
            (bsz, h)))
    _aligned(what, ("zs", zs), ("w", w))
    dev = zs.get_device()
    dzs = torch.empty_like(zs)
    dh0 = zs.new_empty((bsz, h))
    dc0 = zs.new_empty((bsz, h))
    count = torch.zeros(1, dtype=torch.int32, device=zs.device)
    err = _launch(dev, build_bwd().lstm_seq_bwd,
                  zs.data_ptr(), cs.data_ptr(), w.data_ptr(), g.data_ptr(),
                  None if dc is None else dc.data_ptr(), dzs.data_ptr(),
                  dh0.data_ptr(), dc0.data_ptr(), count.data_ptr(), s, bsz,
                  k - h, h, walk_units(h, _sms(dev)))
    if err != 0:
        raise RuntimeError(f"lstm_seq_bwd kernel launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 1
    return dzs, dh0, dc0
