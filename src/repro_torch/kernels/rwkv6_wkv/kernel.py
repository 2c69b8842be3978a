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

Its gradient is a kernel of its own, ``csrc/wkv6_bwd.cu`` (``wkv6_bwd``):
the same 32-step chunked form run backward, every chunk at once. One
kernel forms each chunk's ``k~^T v`` and ``r~^T gy`` on the tensor cores
(3xTF32); a second walks the chunk boundaries, a thread per four state
entries, for the state entering and the state gradient leaving each chunk
(in fp32 on the CUDA cores); a third gives each chunk's dr, dk, dv and dlw
from its two boundaries in five more products, dlw by a sum that never
crosses a chunk. The sequential form it replaces was bound by one step's
latency times S; this one by the boundaries' traffic and the two chunk
kernels' waves of loads and products. The source's header states it.

Each is built with nvcc at first use (or by ``build()`` /
``build_bwd()``) and bound with ctypes. ``launches`` and ``bwd_launches``
count every launch, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "wkv6.cu")
SOURCE_BWD = os.path.join(os.path.dirname(__file__), "csrc", "wkv6_bwd.cu")
HEAD_DIMS = (32, 64)
# the backward kernel's chunk: its workspace's size follows from it
BWD_CHUNK = 32

launches = 0
bwd_launches = 0
# calls a fake-tensor trace made through the ops (``ops.py``): what a
# traced step would launch; never a launch
fake_calls = 0
bwd_fake_calls = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("wkv6", (SOURCE,))
    fn = lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def build_bwd() -> ctypes.CDLL:
    """Compile (once) and load the backward kernel's library."""
    lib = _build.load("wkv6_bwd", (SOURCE_BWD,))
    fn = lib.wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(r, k, v, lw, u, state0, gy=None, gs=None) -> None:
    named = [("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u)]
    for name, t in (("state0", state0), ("gy", gy), ("gs", gs)):
        if t is not None:
            named.append((name, t))
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
    states = [t for t in (state0, gs) if t is not None]
    if any(tuple(t.shape) != tuple(r.shape) for t in (k, v, lw)) \
            or (gy is not None and tuple(gy.shape) != tuple(r.shape)) \
            or tuple(u.shape) != (h, dh) \
            or any(tuple(t.shape) != (b, h, dh, dh) for t in states):
        raise ValueError(
            f"wkv6 kernel: shapes disagree: r {tuple(r.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, lw {tuple(lw.shape)}, "
            f"u {tuple(u.shape)}, " + ", ".join(
                f"{name} {None if t is None else tuple(t.shape)}"
                for name, t in (("state0", state0), ("gy", gy),
                                ("gs", gs))))
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


def bwd_workspace(b: int, s: int, h: int, dh: int) -> Tuple[int, ...]:
    """The shape of the flat float32 workspace ``wkv6_bwd`` allocates: per
    (b, h) and chunk of ``BWD_CHUNK`` steps the state entering it and the
    state gradient leaving it (2 dh^2), the chunk's decay and du's part of
    it (2 dh)."""
    chunks = -(-s // BWD_CHUNK)
    return (b * h * chunks * (2 * dh * dh + 2 * dh),)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor,
             state0: Optional[torch.Tensor], gy: torch.Tensor,
             gs: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``wkv6_fwd``: its inputs as there, gy (B, S, H, dh)
    the cotangent of y and gs (B, H, dh, dh) that of the final state or
    None (zeros), all contiguous float32 on one CUDA device. Returns (dr,
    dk, dv, dlw, du, dstate0, workspace): dstate0 None where state0 is,
    and the float32 workspace of ``bwd_workspace``, which the caller
    drops."""
    global bwd_launches
    _check(r, k, v, lw, u, state0, gy, gs)
    lib = build_bwd()
    b, s, h, dh = r.shape
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    work = torch.empty(bwd_workspace(b, s, h, dh), dtype=r.dtype,
                       device=r.device)
    dstate0 = None if state0 is None else torch.empty_like(state0)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wkv6_bwd(
            ptr(r), ptr(k), ptr(v), ptr(lw), ptr(u), ptr(state0), ptr(gy),
            ptr(gs), ptr(dr), ptr(dk), ptr(dv), ptr(dlw), ptr(work),
            ptr(du), ptr(dstate0), b, s, h, dh, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward kernel launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    return dr, dk, dv, dlw, du, dstate0, work
