"""Launch the hand-written Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

The CUDA source replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd``; its
header states the design and the bound. It is built with nvcc at first use
(or by ``build()``) and bound with ctypes. ``launches`` counts every launch,
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc",
                      "flash_attention.cu")
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("flash_attention", (SOURCE,))
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not on a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype}, "
                             f"q {q.dtype}; the kernel takes float32 or "
                             "bfloat16, one type for all three")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not "
                             "contiguous")
        if t.dim() != 3:
            raise ValueError(f"flash_attention kernel: want (BH, S, dh) "
                             f"tensors; {name} is {tuple(t.shape)}")
    bh, sq, dh = q.shape
    bhkv, skv, dhk = k.shape
    if tuple(v.shape) != tuple(k.shape) or dhk != dh or bhkv == 0 \
            or bh % bhkv:
        raise ValueError(
            f"flash_attention kernel: shapes disagree: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(bh, sq, skv, dh) == 0 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: takes non-empty inputs "
                         f"with head_dim <= {MAX_HEAD_DIM}; got "
                         f"{tuple(q.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, dh); k/v: (BHkv, Skv, dh), contiguous, all float32 or all
    bfloat16 on one CUDA device. Returns (BH, Sq, dh) in q's type."""
    global launches
    _check(q, k, v)
    lib = build()
    bh, sq, dh = q.shape
    bhkv, skv, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            bhkv, sq, skv, dh, int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
