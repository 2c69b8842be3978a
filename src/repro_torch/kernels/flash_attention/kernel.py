"""Launch the hand-written Hopper flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its gradient
(``csrc/flash_attention_bwd.cu``), which share the Hopper building blocks
of ``csrc/hopper.cuh``.

The forward replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd``; its
header states the design and the bound. Beside o it writes each row's
log-sum-exp (fp32, (B, Hq, Sq), natural log of the scaled scores), which
the backward reads to recompute P tile by tile. The backward replaces the
JAX package's VJP of its oracle (no Pallas backward exists). It is
deterministic, with no float atomics: on the tensor-core path one fused
FlashAttention-3-style kernel a call (a block per key tile, D and P from
the saved lse, dK and dV in registers, dQ added into an fp32 workspace in a
fixed order of key tiles), between a D pass and a pass that writes dq in
bf16; on the CUDA-core path three kernels (D; dK and dV; dQ). Its header
states the design and the bound.

Each is built with nvcc at first use (or by ``build()`` / ``build_bwd()``)
and bound with ctypes. Both have two paths, chosen by ``select_path`` from
the type and the head dimension alone: bfloat16 with head_dim 64, 128 or
192 runs the tensor-core path (``wgmma`` and TMA), anything else up to
head_dim 256 the CUDA-core path. ``launches`` / ``bwd_launches`` count
every launch and ``launches_tc`` / ``launches_simt`` (``bwd_launches_tc`` /
``bwd_launches_simt``) each path's, so a run can show that its path went
through the kernels, and through which half of them.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc",
                      "flash_attention.cu")
SOURCE_BWD = os.path.join(os.path.dirname(__file__), "csrc",
                          "flash_attention_bwd.cu")
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128, 192)
# the tensor-core backward's tiles by head dim: (keys a block, query rows a
# step), as ``csrc/flash_attention_bwd.cu``'s ``Tiles``
TC_BWD_TILES = {64: (128, 128), 128: (128, 64), 192: (64, 64)}
# an H100's SMs, and half its 50 MB L2: the backward splits a GQA group
# over blocks until its grid has at least SMS blocks and the fp32 dQ tiles
# that the blocks on the card at once add to fit in L2_BUDGET (from the
# shape alone, so that a trace on fake tensors allocates what the card does)
SMS = 132
L2_BUDGET = 25 * 2 ** 20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_tc = 0
launches_simt = 0
bwd_launches = 0
bwd_launches_tc = 0
bwd_launches_simt = 0
# calls a fake-tensor trace made through the ops (``ops.py``): what a
# traced step would launch; never a launch
fake_calls = 0
bwd_fake_calls = 0


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile (once) and load the kernel library; returns the CDLL."""
    lib = _build.load("flash_attention", (SOURCE,))
    head = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    lib.flash_attention_fwd_simt.argtypes = head + [ctypes.c_int,
                                                    ctypes.c_void_p]
    lib.flash_attention_fwd_tc.argtypes = head + [ctypes.c_void_p]
    lib.flash_attention_fwd_simt.restype = ctypes.c_int
    lib.flash_attention_fwd_tc.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def build_bwd() -> ctypes.CDLL:
    """Compile (once) and load the backward kernel's library."""
    lib = _build.load("flash_attention_bwd", (SOURCE_BWD,))
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
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


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor,
                     g: torch.Tensor) -> str:
    """Raise ValueError on what the backward kernel does not take; return
    the path that ``select_path`` gives. q, k and v as ``check_inputs``
    takes them; o and g (the cotangent of o) in q's type and shape with a
    contiguous head dimension (on the tensor-core path both also 16-byte
    aligned with strides of multiples of 8 elements: g is read as q is, o
    by 16-byte loads);
    lse the forward's contiguous float32 (B, Hq, Sq). Looks at types,
    shapes and strides only, so it runs without a card."""
    path = check_inputs(q, k, v)
    for name, t in (("o", o), ("g", g)):
        if t.dtype != q.dtype or tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"flash_attention backward kernel: {name} is "
                             f"{t.dtype} {tuple(t.shape)}, q {q.dtype} "
                             f"{tuple(q.shape)}")
        if t.stride(3) != 1 and q.shape[3] > 1:
            raise ValueError(f"flash_attention backward kernel: {name}'s "
                             "head dimension is not contiguous")
    for name, t in (("o", o), ("g", g)):
        if path == "tc" and (t.data_ptr() % 16 or any(
                st <= 0 or st % 8 for st in _strides(t))):
            raise ValueError(f"flash_attention backward kernel: the "
                             f"tensor-core path reads {name} by 16-byte "
                             f"loads and g by TMA, which need a 16-byte "
                             f"aligned start and (B, S, H) strides that are "
                             f"positive multiples of 8 elements; got stride "
                             f"{t.stride()}")
    b, sq, hq, _ = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward kernel: lse must be a "
                         f"contiguous float32 {(b, hq, sq)}; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    return path


def bwd_parts(b: int, hq: int, hkv: int, sq: int, skv: int, dh: int) -> int:
    """How many blocks the tensor-core backward splits each GQA group of
    query heads over: the least divisor of the group that gives (B, KV
    head, key tile, part) at least ``SMS`` blocks and keeps the dQ that the
    blocks on the card at once add to within ``L2_BUDGET`` (a block walks
    its part's heads in turn, and a dQ tile is added to by every key tile
    of its head: with many heads a block, the first and last adds to a tile
    lie far apart, and the tile leaves L2 between them); else the whole
    group (a head a block). A part's dK and dV are fp32 in the workspace,
    summed in order by the last pass; one part keeps the group in
    registers."""
    bk, bq = TC_BWD_TILES[dh]
    group = hq // hkv
    n_kt = -(-skv // bk)
    head_dq = -(-sq // bq) * bq * dh * 4
    for p in range(1, group + 1):
        held = min(max(SMS // n_kt, 1), b * hkv * p)
        if group % p == 0 and b * hkv * n_kt * p >= SMS \
                and group // p * head_dq * held <= L2_BUDGET:
            return p
    return group


def bwd_workspace(b: int, hq: int, hkv: int, sq: int, skv: int, dh: int,
                  path: str) -> int:
    """float32 elements of the backward's workspace. CUDA-core path: D,
    (B, Hq, Sq). Tensor-core path, with query rows padded to whole tiles of
    ``TC_BWD_TILES``: lse * log2 e and D (2 B Hq pad); a counter a (b,
    query head, query tile), rounded up to 4; dQ in fp32, a tile each; with
    ``bwd_parts`` > 1 the parts of dK and of dV, fp32 (B, Skv, Hkv, dh)
    each. The layout is ``csrc/flash_attention_bwd.cu``'s ``tc::launch``."""
    if path != "tc":
        return b * hq * sq
    bq = TC_BWD_TILES[dh][1]
    n_qt = -(-sq // bq)
    tiles = b * hq * n_qt
    parts = bwd_parts(b, hq, hkv, sq, skv, dh)
    kv = 2 * parts * b * skv * hkv * dh if parts > 1 else 0
    return 2 * b * hq * n_qt * bq + -(-tiles // 4) * 4 + tiles * bq * dh + kv


def _on_one_card(named) -> None:
    q = named[0][1]
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not on a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, q on {q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, dh); k/v: (B, Skv, Hkv, dh), all float32 or all
    bfloat16 on one CUDA device, each with a contiguous head dimension and
    any (B, S, H) strides, read in place. Returns o (B, Sq, Hq, dh),
    contiguous, in q's type, and lse (B, Hq, Sq), float32: each row's
    log-sum-exp of its scaled scores, which the backward kernel reads."""
    global launches, launches_tc, launches_simt
    _on_one_card((("q", q), ("k", k), ("v", v)))
    path = check_inputs(q, k, v)
    lib = build()
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in _strides(t)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), strides, b, hq, hkv, sq, skv, dh,
                int(causal))
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
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``flash_attention_fwd``: q, k, v as there, o and lse
    its results and g the cotangent of o (q's type and shape, any (B, S,
    H) strides), all on one CUDA device. Returns (dq, dk, dv, workspace):
    the gradients contiguous, in q's and k's shapes and type, and the
    float32 workspace of ``bwd_workspace``, which the caller drops. Two
    calls on the same inputs give the same gradients to the bit."""
    global bwd_launches, bwd_launches_tc, bwd_launches_simt
    _on_one_card((("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
                  ("g", g)))
    path = check_bwd_inputs(q, k, v, o, lse, g)
    lib = build_bwd()
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    parts = bwd_parts(b, hq, hkv, sq, skv, dh) if path == "tc" else 1
    dq = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, skv, hkv, dh), dtype=k.dtype, device=q.device)
    work = torch.empty(bwd_workspace(b, hq, hkv, sq, skv, dh, path),
                       dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (q, k, v, o, g) for s in _strides(t)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            g.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, b, hq, hkv, sq, skv, dh,
            int(causal), _DTYPES[q.dtype], int(path == "tc"), parts, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel ({path} path) "
                           f"launch failed: error {err}")
    bwd_launches += 1
    if path == "tc":
        bwd_launches_tc += 1
    else:
        bwd_launches_simt += 1
    return dq, dk, dv, work
