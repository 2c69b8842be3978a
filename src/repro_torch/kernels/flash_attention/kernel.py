"""Launch the hand-written Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

The CUDA source replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd``; its
header states the design and the bound. It is built with nvcc at first use
(or by ``build()``) and bound with ctypes. It has two paths, chosen by
``select_path`` from the type and the head dimension alone: bfloat16 with
head_dim 64, 128 or 192 runs the tensor-core path (``wgmma`` and TMA),
anything else up to head_dim 256 the CUDA-core path. ``launches`` counts
every launch and ``launches_tc`` / ``launches_simt`` each path's, so a run
can show that its path went through the kernel, and through which half of
it.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc",
                      "flash_attention.cu")
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_tc = 0
launches_simt = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("flash_attention", (SOURCE,))
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    lib.flash_attention_fwd_simt.argtypes = head + [ctypes.c_int,
                                                    ctypes.c_void_p]
    lib.flash_attention_fwd_tc.argtypes = head + [ctypes.c_void_p]
    lib.flash_attention_fwd_simt.restype = ctypes.c_int
    lib.flash_attention_fwd_tc.restype = ctypes.c_int
    return lib


def select_path(dtype: torch.dtype, head_dim: int) -> str:
    """``"tc"`` (tensor cores) for bfloat16 at head_dim 64, 128 or 192,
    else ``"simt"`` (CUDA cores); the only place the choice is made."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def _strides(t: torch.Tensor):
    """(B, S, H) element strides, a dimension of size 1 given the stride a
    contiguous tensor would have (its stride is never used, and TMA wants
    every stride a positive multiple of 16 bytes)."""
    b, s, h, d = t.shape
    sb, ss, sh, _ = t.stride()
    sh = sh if h > 1 else d
    ss = ss if s > 1 else h * sh
    sb = sb if b > 1 else s * ss
    return sb, ss, sh


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Raise ValueError on what the kernel does not take; return the path
    that ``select_path`` gives. Looks at types, shapes and strides only, not
    at the device, so it runs without a card."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype}, "
                             f"q {q.dtype}; the kernel takes float32 or "
                             "bfloat16, one type for all three")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: want (B, S, H, dh) "
                             f"tensors; {name} is {tuple(t.shape)}")
    b, sq, hq, dh = q.shape
    bk, skv, hkv, dhk = k.shape
    if tuple(v.shape) != tuple(k.shape) or bk != b or dhk != dh \
            or hkv == 0 or hq % hkv:
        raise ValueError(
            f"flash_attention kernel: shapes disagree: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(b, sq, skv, hq, dh) == 0 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: takes non-empty inputs "
                         f"with head_dim <= {MAX_HEAD_DIM}; got "
                         f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 and dh > 1:
            raise ValueError(f"flash_attention kernel: {name}'s head "
                             "dimension is not contiguous")
    path = select_path(q.dtype, dh)
    if path == "tc":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st <= 0 or st % 8
                                        for st in _strides(t)):
                raise ValueError(
                    f"flash_attention kernel: the tensor-core path reads "
                    f"{name} by TMA, which needs a 16-byte aligned start "
                    f"and (B, S, H) strides that are positive multiples of "
                    f"8 elements; got stride {t.stride()}")
    return path


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k/v: (B, Skv, Hkv, dh), all float32 or all
    bfloat16 on one CUDA device, each with a contiguous head dimension and
    any (B, S, H) strides, read in place. Returns o (B, Sq, Hq, dh),
    contiguous, in q's type."""
    global launches, launches_tc, launches_simt
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not on a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, q on {q.device}")
    path = check_inputs(q, k, v)
    lib = build()
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in _strides(t)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, hq, hkv, sq, skv, dh, int(causal))
        if path == "tc":
            err = lib.flash_attention_fwd_tc(*args, stream)
        else:
            err = lib.flash_attention_fwd_simt(*args, _DTYPES[q.dtype],
                                               stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({path} path) launch "
                           f"failed: error {err}")
    launches += 1
    if path == "tc":
        launches_tc += 1
    else:
        launches_simt += 1
    return out
