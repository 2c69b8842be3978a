"""Collective traffic of one step, per kind: ``CollectiveStats``, a copy
of the dataclass in ``repro.perfmodel.hlo``, and ``CollectiveCounter``,
which fills it.

The reference fills the record by parsing compiled XLA HLO text
(``parse_collectives``), which the port never produces. The port's dry run
counts a sharded step's collectives as they dispatch instead:
``CollectiveCounter`` is a ``TorchDispatchMode`` that sees every
``_c10d_functional`` op a DTensor redistribution calls (with a fake
process group under ``FakeTensorMode`` too) and adds its kind and per-device
bytes, as the reference counts them: the result buffer, except a
reduce-scatter's operand (its result is the scattered shard). Buffer bytes
convert to on-the-wire bytes with standard ring-algorithm factors.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.perfmodel.counters import on_dtensors, propagating

# wire-bytes factor per buffer byte (ring algorithms, large k limit)
_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


@dataclass
class CollectiveStats:
    count: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    buffer_bytes: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))

    @property
    def wire_bytes(self) -> float:
        return sum(_WIRE_FACTOR[k] * v for k, v in self.buffer_bytes.items())

    @property
    def total_count(self) -> int:
        return sum(self.count.values())

    def scaled(self, factor: float) -> "CollectiveStats":
        out = CollectiveStats()
        for k in self.count:
            out.count[k] = int(self.count[k] * factor)
            out.buffer_bytes[k] = int(self.buffer_bytes[k] * factor)
        return out

    def minus(self, other: "CollectiveStats") -> "CollectiveStats":
        out = CollectiveStats()
        for k in set(self.count) | set(other.count):
            out.count[k] = self.count[k] - other.count[k]
            out.buffer_bytes[k] = (self.buffer_bytes[k]
                                   - other.buffer_bytes[k])
        return out

    def plus(self, other: "CollectiveStats") -> "CollectiveStats":
        out = CollectiveStats()
        for k in set(self.count) | set(other.count):
            out.count[k] = self.count[k] + other.count[k]
            out.buffer_bytes[k] = (self.buffer_bytes[k]
                                   + other.buffer_bytes[k])
        return out

    def wire_bytes_of(self, kinds) -> float:
        """Wire bytes restricted to the given collective kinds."""
        return sum(_WIRE_FACTOR[k] * self.buffer_bytes.get(k, 0)
                   for k in kinds)

    def to_dict(self) -> Dict[str, Dict[str, int]]:
        return {k: {"count": self.count[k], "bytes": self.buffer_bytes[k]}
                for k in sorted(self.count)}

    @classmethod
    def from_dict(cls, d: Dict[str, Dict[str, int]]) -> "CollectiveStats":
        out = cls()
        for k, v in d.items():
            out.count[k] = int(v.get("count", 0))
            out.buffer_bytes[k] = int(v.get("bytes", 0))
        return out


# functional collective op (and its in-place / out variants) -> the
# reference's HLO kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched inside its ``with`` block into
    ``self.stats``: one device's view, what DTensor sends from this rank
    (the DTensor-level op is left to DTensor, as ``perfmodel.counters``'
    modes leave it)."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(func._opname) \
            if func.namespace in _NAMESPACES else None
        if kind is not None and not propagating():
            buf = args[0] if kind == "reduce-scatter" else out
            self.stats.count[kind] += 1
            self.stats.buffer_bytes[kind] += _nbytes(buf)
        return out
