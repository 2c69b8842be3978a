"""Error-feedback gradient compression for the data-parallel all-reduce
(a port of ``repro.dist.compression``).

The DP gradient all-reduce moves one full parameter-sized buffer per step;
at production scale it is the dominant communication term that does NOT
scale with sequence length. We compress the wire format and carry the
quantization error forward as an *error-feedback residual* (Seide et al.
1-bit SGD; Karimireddy et al. EF-SGD): the residual is added to the next
step's gradients before compression, so the quantization noise is unbiased
over time and the compressed loss curve tracks the uncompressed one.

Methods (``OptimizerConfig.grad_compression``):
  none      — identity.
  bf16      — cast to bfloat16 on the wire (2x), residual = rounding error.
  int8_ef   — per-tensor absmax int8 quantization (4x), error feedback.
  topk_ef   — keep the top ``TOPK_FRACTION`` entries by magnitude exactly
              (sparsification), error feedback carries the rest.

The unit of a "tensor" is the reference's leaf. The reference stacks the
layers of one pattern position on a leading axis (``layers/0/mixer/wq`` is
``(num_layers // period, ...)``), so its int8 scale and its top-k run over
all those layers at once. The port keeps one tensor a layer
(``layers.N.mixer.wq``), so it stacks them back the reference's way
(``leaf_groups``; the encoder-decoder's ``enc_layers`` and ``dec_layers``
likewise) before it compresses: the same wire and residual. The
wire format is ``{part: {reference leaf path: tensor}}``; gradients and
residuals are ``{port parameter name: tensor}``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch

Named = Mapping[str, torch.Tensor]

TOPK_FRACTION = 0.05

METHODS = ("none", "bf16", "int8_ef", "topk_ef")

# wire bytes per gradient element (f32 baseline is 4)
WIRE_BYTES_PER_ELEM = {
    "none": 4.0,
    "bf16": 2.0,
    "int8_ef": 1.0,
    "topk_ef": TOPK_FRACTION * 8.0,     # (int32 index + f32 value) per kept
}


def wire_bytes_per_elem(method: str, grad_dtype_bytes: float = 4.0) -> float:
    """Per-element wire width for ``method``, given the *native* gradient
    dtype width. Only "none" ships the native dtype (bf16 grads -> 2 bytes
    uncompressed); the other methods fix their own wire format regardless
    of what the gradients started as."""
    _check(method)
    if method == "none":
        return float(grad_dtype_bytes)
    return WIRE_BYTES_PER_ELEM[method]


def uses_error_feedback(method: str) -> bool:
    return method.endswith("_ef")


def _check(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown grad compression {method!r}; "
                         f"one of {METHODS}")


def _topk_k(n: int) -> int:
    return max(1, int(math.ceil(TOPK_FRACTION * n)))


# the port's layer lists that the reference stacks on a leading axis
STACKS = ("layers", "enc_layers", "dec_layers")


def leaf_groups(names, period: int) -> Dict[str, List[str]]:
    """The reference's leaf path of each group of port parameters, with
    the group's names in stacking order: ``layers.N.<rest>`` goes to
    ``layers/<N % period>/<rest>`` at index ``N // period``; the
    encoder-decoder's ``enc_layers.N.<rest>`` and ``dec_layers.N.<rest>``
    (one vmapped stack each, period 1) go to ``enc_layers/<rest>`` and
    ``dec_layers/<rest>`` at index ``N``; every other name is a leaf of
    its own (``lm_head`` -> ``lm_head``)."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            n = int(parts[1])
            key = "/".join(["layers", str(n % period)] + parts[2:])
            groups.setdefault(key, []).append((n // period, name))
        elif parts[0] in STACKS:
            key = "/".join([parts[0]] + parts[2:])
            groups.setdefault(key, []).append((int(parts[1]), name))
        else:
            groups.setdefault("/".join(parts), []).append((0, name))
    return {k: [n for _, n in sorted(v)] for k, v in groups.items()}


def _is_stack(key: str) -> bool:
    return key.split("/")[0] in STACKS


def _stacked(grads: Named, key: str, names: List[str]) -> torch.Tensor:
    """A group's gradients as the reference's leaf, in float32."""
    if not _is_stack(key):
        return grads[names[0]].float()
    return torch.stack([grads[n].float() for n in names])


def _unstack(t: torch.Tensor, key: str, names: List[str]
             ) -> Dict[str, torch.Tensor]:
    if not _is_stack(key):
        return {names[0]: t}
    return dict(zip(names, t.unbind(0)))


def compress_grads(grads: Named, method: str = "int8_ef", *, period: int = 1
                   ) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                              Optional[Dict[str, torch.Tensor]]]:
    """Compress named gradients to their wire format.

    Returns ``(wire, residual)`` where ``residual = grads -
    decompress(wire)`` (float32, one tensor per parameter) is the
    error-feedback state to add to the *next* step's gradients (``None``
    for method "none"). ``period`` is the model's pattern length, which
    decides how layers stack into the reference's leaves.
    """
    _check(method)
    if method == "none":
        return {"q": dict(grads)}, None
    wire: Dict[str, Dict[str, torch.Tensor]] = {}
    err: Dict[str, torch.Tensor] = {}
    for key, names in leaf_groups(grads, period).items():
        g = _stacked(grads, key, names)
        if method == "bf16":
            q = g.to(torch.bfloat16)
            parts, e = {"q": q}, g - q.float()
        elif method == "int8_ef":
            s = torch.clamp_min(g.abs().max() / 127.0, 1e-30)
            q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
            parts, e = {"q": q, "scale": s}, g - q.float() * s
        else:
            flat = g.reshape(-1)
            idx = torch.topk(flat.abs(), _topk_k(flat.numel()))[1]
            e = flat.clone()
            e[idx] = 0.0
            parts = {"idx": idx.to(torch.int32), "vals": flat[idx]}
            e = e.reshape(g.shape)
        for part, t in parts.items():
            wire.setdefault(part, {})[key] = t
        err.update(_unstack(e, key, names))
    return wire, err


def decompress_grads(wire: Mapping[str, Mapping[str, torch.Tensor]],
                     method: str, like: Named, *, period: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """Rebuild dense named gradients (dtype of ``like``) from the wire
    format produced by ``compress_grads``."""
    _check(method)
    if method == "none":
        return dict(wire["q"])
    out: Dict[str, torch.Tensor] = {}
    for key, names in leaf_groups(like, period).items():
        if method == "bf16":
            dense = wire["q"][key].float()
        elif method == "int8_ef":
            dense = wire["q"][key].float() * wire["scale"][key]
        else:
            ref = like[names[0]]
            shape = (len(names),) + tuple(ref.shape) if _is_stack(key) \
                else tuple(ref.shape)
            dense = torch.zeros(math.prod(shape), dtype=torch.float32,
                                device=ref.device)
            dense[wire["idx"][key].long()] = wire["vals"][key]
            dense = dense.reshape(shape)
        for name, t in _unstack(dense, key, names).items():
            out[name] = t.to(like[name].dtype)
    return out


def init_residual(params: Named, method: str
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """Zero error-feedback state (one float32 tensor per parameter), or
    ``None`` for methods without error feedback."""
    _check(method)
    if not uses_error_feedback(method):
        return None
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


# ---------------------------------------------------------------------------
# wire accounting (surfaced into EpochLog.stats by the trainer)


def dp_grad_wire_bytes(params: Named, method: str, dp_degree: int, *,
                       grad_dtype_bytes: float = 4.0,
                       micro_reduces: int = 1) -> float:
    """Per-step on-the-wire bytes of the DP gradient reduction under
    ``method`` compression on a ``dp_degree``-way ring (2*(n-1)/n per
    buffer byte). 0 when there is no data parallelism.

    ``grad_dtype_bytes`` is the native gradient width (2 for bf16 grads);
    it only matters for method "none" — see ``wire_bytes_per_elem``.
    ``micro_reduces`` is how many parameter-sized reductions one optimizer
    step makes: 1 for plain DP (grads accumulate locally, one all-reduce),
    ``run.microbatches`` under ZeRO-3, whose per-microbatch reduce-scatter
    cannot be deferred because no device holds the full gradient.
    """
    _check(method)
    if dp_degree <= 1:
        return 0.0
    n_elem = sum(int(p.numel()) for p in params.values())
    buf = n_elem * wire_bytes_per_elem(method, grad_dtype_bytes)
    reduces = max(1, int(micro_reduces))
    return float(2.0 * (dp_degree - 1) / dp_degree * buf * reduces)
