"""Collective traffic of one step, per kind: ``CollectiveStats``, a copy
of the dataclass in ``repro.perfmodel.hlo``.

The reference fills it by parsing compiled XLA HLO text
(``parse_collectives``), which the port never produces; the port's dry run
will count a sharded step's collectives with ``CommDebugMode`` into the
same record. Buffer bytes convert to on-the-wire bytes with standard
ring-algorithm factors.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

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
