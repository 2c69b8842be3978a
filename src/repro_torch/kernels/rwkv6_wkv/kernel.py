"""Launch the hand-written Hopper WKV6 kernel (``csrc/wkv6.cu``).

The CUDA source replaces the Pallas TPU kernel
``src/repro/kernels/rwkv6_wkv/kernel.py::wkv6_fwd``. It is bound by the
bytes it must move (r, k, v, lw and y once: 0.095 ms at rwkv6-3b's
(4, 1536, 40, 64) on an H100). As the Pallas kernel does, it cuts the
sequence into chunks (32 steps, where the Pallas kernel takes 64) and runs
each chunk's four products
(``r~ k~^T``, ``att v``, ``r~ S`` and ``k~^T v``) on the tensor cores, in
the 3xTF32 split that keeps fp32's accuracy to the 5e-4 tolerance; one
block of eight warps owns one (b, h), with the next chunk staged by
``cp.async`` while this one computes. S = 1 (decode) runs a kernel of its
own that reads and writes the state once. The source's header states the
design in full.

Precondition: ``lw`` in [-1, 0), which the model's clamp guarantees
(``models/rwkv.py::_log_decay``), so that ``exp(-cumsum(lw))`` over a chunk
stays finite in fp32; the Pallas kernel assumes the same.

It is built with nvcc at first use (or by ``build()``) and bound with
ctypes. ``launches`` counts every launch, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "wkv6.cu")
HEAD_DIMS = (32, 64)

launches = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("wkv6", (SOURCE,))
    fn = lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(r, k, v, lw, u, state0) -> None:
    named = [("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u)]
    if state0 is not None:
        named.append(("state0", state0))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"wkv6 kernel: {name} is on {t.device}, not on "
                             "a CUDA device")
        if t.device != r.device:
            raise ValueError(f"wkv6 kernel: {name} is on {t.device}, r on "
                             f"{r.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"wkv6 kernel: {name} is {t.dtype}; the kernel "
                             "takes float32")
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6 kernel: {name} is not 16-byte aligned")
    if r.dim() != 4:
        raise ValueError(f"wkv6 kernel: want (B, S, H, dh) tensors; r is "
                         f"{tuple(r.shape)}")
    b, s, h, dh = r.shape
    if any(tuple(t.shape) != tuple(r.shape) for t in (k, v, lw)) \
            or tuple(u.shape) != (h, dh) or (
                state0 is not None
                and tuple(state0.shape) != (b, h, dh, dh)):
        raise ValueError(
            f"wkv6 kernel: shapes disagree: r {tuple(r.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, lw {tuple(lw.shape)}, "
            f"u {tuple(u.shape)}, state0 "
            f"{None if state0 is None else tuple(state0.shape)}")
    if min(b, s, h) == 0 or dh not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel: takes non-empty inputs with head_dim "
                         f"in {HEAD_DIMS}; got {tuple(r.shape)}")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/lw: (B, S, H, dh), lw in [-1, 0); u: (H, dh); state0:
    (B, H, dh, dh) or None (zeros); all contiguous float32 on one CUDA
    device. Returns y (B, S, H, dh) and the final state (B, H, dh, dh),
    both float32."""
    global launches
    _check(r, k, v, lw, u, state0)
    lib = build()
    b, s, h, dh = r.shape
    y = torch.empty_like(r)
    state = torch.empty((b, h, dh, dh), dtype=r.dtype, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, s, h, dh, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state
