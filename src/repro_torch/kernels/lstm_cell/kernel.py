"""Launch the hand-written Hopper LSTM-cell kernel (``csrc/lstm_cell.cu``).

The CUDA source replaces the Pallas TPU kernel
``src/repro/kernels/lstm_cell/kernel.py::lstm_cell_fwd``; its header states
the design and the bound. It is built with nvcc at first use (or by
``build()``) and bound with ctypes. ``launches`` counts every launch, so a
run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "lstm_cell.cu")

launches = 0
# calls a fake-tensor trace made through the op (``ops.py``): what a
# traced step would launch; never a launch
fake_calls = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("lstm_cell", (SOURCE,))
    fn = lib.lstm_cell_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(xh, w, b, c) -> None:
    # runs once per timestep of every LSTM layer: device and type are
    # compared as an int and by identity, the cheap way
    dev = xh.get_device()
    for name, t in (("xh", xh), ("w", w), ("b", b), ("c", c)):
        if not t.is_cuda:
            raise ValueError(f"lstm_cell kernel: {name} is on {t.device}, "
                             "not on a CUDA device")
        if t.get_device() != dev:
            raise ValueError(f"lstm_cell kernel: {name} is on {t.device}, "
                             f"xh on {xh.device}")
        if t.dtype is not torch.float32:
            raise ValueError(f"lstm_cell kernel: {name} is {t.dtype}; "
                             "the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell kernel: {name} is not contiguous")
    if xh.dim() != 2 or w.dim() != 3 or w.shape[2] != 4:
        raise ValueError(f"lstm_cell kernel: want xh (B, K), w (K, H, 4); "
                         f"got {tuple(xh.shape)}, {tuple(w.shape)}")
    bsz, k = xh.shape
    h = w.shape[1]
    if w.shape[0] != k or tuple(b.shape) != (h, 4) \
            or tuple(c.shape) != (bsz, h):
        raise ValueError(
            f"lstm_cell kernel: shapes disagree: xh {tuple(xh.shape)}, "
            f"w {tuple(w.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if bsz == 0 or k == 0 or h == 0:
        raise ValueError("lstm_cell kernel: empty input")
    if w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("lstm_cell kernel: w and b must be 16-byte aligned")


def lstm_cell_fwd(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H), all contiguous
    float32 on one CUDA device. Returns (h_new, c_new), each (B, H)."""
    global launches
    _check(xh, w, b, c)
    lib = build()
    bsz, k = xh.shape
    h = w.shape[1]
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lstm_cell_fwd(xh.data_ptr(), w.data_ptr(), b.data_ptr(),
                                c.data_ptr(), h_out.data_ptr(),
                                c_out.data_ptr(), bsz, k, h, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error {err}")
    launches += 1
    return h_out, c_out
