"""Launch the hand-written Hopper selective-scan kernel
(``csrc/mamba_scan.cu``).

The CUDA source replaces the Pallas TPU kernel
``src/repro/kernels/mamba_scan/kernel.py::mamba_scan_fwd``. It is bound by
the bytes it must move (x, delta and y once: 0.151 ms at jamba's
(4, 1536, 8192, 16) on an H100), with its exps close behind. One thread
steps one channel with all N states in registers, each exp is one
instruction of the special-function units, and ``cp.async`` stages the
next 32 steps while the recurrence runs; the source's header states the
design in full, and what was measured against it. It reads x, B, C and
D in their stored type (bf16 or float32) and B and C through their
strides, so a call launches the kernel and nothing else. It is built with
nvcc at first use (or by ``build()``) and bound with ctypes. ``launches``
counts every launch, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "mamba_scan.cu")
STATE_DIMS = (4, 8, 16)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
# calls a fake-tensor trace made through the op (``ops.py``): what a
# traced step would launch; never a launch
fake_calls = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("mamba_scan", (SOURCE,))
    fn = lib.mamba_scan_fwd
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, i, vp, vp, vp, vp, i, ll, ll, ll, ll, vp, i, vp, vp,
                   vp, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return lib


def _check(x, delta, a, b, c, d, state0) -> None:
    named = [("x", x), ("delta", delta), ("a", a), ("b", b), ("c", c),
             ("d", d)]
    if state0 is not None:
        named.append(("state0", state0))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"mamba_scan kernel: {name} is on {t.device}, "
                             "not on a CUDA device")
        if t.device != x.device:
            raise ValueError(f"mamba_scan kernel: {name} is on {t.device}, "
                             f"x on {x.device}")
    for name, t in (("x", x), ("b", b), ("c", c), ("d", d)):
        if t.dtype not in _BF16:
            raise ValueError(f"mamba_scan kernel: {name} is {t.dtype}; the "
                             "kernel takes float32 or bfloat16")
    if b.dtype != c.dtype:
        raise ValueError(f"mamba_scan kernel: b is {b.dtype}, c {c.dtype}; "
                         "the kernel takes one type for both")
    for name, t in (("delta", delta), ("a", a), ("state0", state0)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"mamba_scan kernel: {name} is {t.dtype}; the "
                             "kernel takes float32")
    for name, t in (("x", x), ("delta", delta), ("a", a), ("d", d),
                    ("state0", state0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"mamba_scan kernel: {name} is not contiguous")
    for name, t in (("b", b), ("c", c)):
        if t.dim() == 3 and t.stride(-1) != 1:
            raise ValueError(f"mamba_scan kernel: {name}'s last dimension is "
                             "not contiguous")
    for name, t in (("a", a), ("state0", state0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"mamba_scan kernel: {name} is not 16-byte "
                             "aligned")
    if x.dim() != 3:
        raise ValueError(f"mamba_scan kernel: want x as (B, S, D); x is "
                         f"{tuple(x.shape)}")
    bsz, s, dim = x.shape
    n = a.shape[-1]
    if tuple(delta.shape) != tuple(x.shape) or tuple(a.shape) != (dim, n) \
            or tuple(b.shape) != (bsz, s, n) \
            or tuple(c.shape) != (bsz, s, n) or tuple(d.shape) != (dim,) \
            or (state0 is not None
                and tuple(state0.shape) != (bsz, dim, n)):
        raise ValueError(
            f"mamba_scan kernel: shapes disagree: x {tuple(x.shape)}, delta "
            f"{tuple(delta.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"c {tuple(c.shape)}, d {tuple(d.shape)}, state0 "
            f"{None if state0 is None else tuple(state0.shape)}")
    if min(bsz, s, dim) == 0 or n not in STATE_DIMS:
        raise ValueError(f"mamba_scan kernel: takes non-empty inputs with "
                         f"d_state in {STATE_DIMS}; got x {tuple(x.shape)}, "
                         f"d_state {n}")


def mamba_scan_fwd(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) contiguous bfloat16 or float32; delta: (B, S, D) and
    a: (D, N) contiguous float32, a 16-byte aligned; d: (D,) contiguous and
    b/c: (B, S, N) with the last dimension contiguous (any other strides),
    each bfloat16 or float32 (b and c of one type); state0: (B, D, N)
    contiguous float32, 16-byte aligned, or None (zeros); all on one CUDA
    device. Returns y (B, S, D) and the final state (B, D, N), both
    float32."""
    global launches
    _check(x, delta, a, b, c, d, state0)
    lib = build()
    bsz, s, dim = x.shape
    n = a.shape[1]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, dim, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mamba_scan_fwd(
            x.data_ptr(), _BF16[x.dtype], delta.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), _BF16[b.dtype],
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            d.data_ptr(), _BF16[d.dtype],
            None if state0 is None else state0.data_ptr(), y.data_ptr(),
            state.data_ptr(), bsz, s, dim, n, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y, state
