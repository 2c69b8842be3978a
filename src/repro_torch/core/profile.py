"""Iteration execution profiles and epoch logs (paper §IV).

An ``EpochLog`` is the artifact of step (1) of the SeqPoint mechanism: one
training epoch's per-iteration (sequence length, runtime, optional stats).
Stats can carry anything that varies with SL — wallclock seconds, analytic
machine-model seconds, HLO FLOPs/bytes, a kernel-category histogram — the
selection algorithm only assumes "runtime" is a good proxy for the profile
(paper §V-C / §VII-C).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class IterationRecord:
    seq_len: int
    runtime: float
    stats: Mapping[str, float] = field(default_factory=dict)


@dataclass
class EpochLog:
    """Per-iteration log of one training epoch."""

    iterations: List[IterationRecord] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    def append(self, seq_len: int, runtime: float, **stats: float) -> None:
        self.iterations.append(IterationRecord(int(seq_len), float(runtime),
                                               dict(stats)))

    # ------------------------------------------------------------------
    @property
    def num_iterations(self) -> int:
        return len(self.iterations)

    @property
    def total_runtime(self) -> float:
        return float(sum(it.runtime for it in self.iterations))

    def total_stat(self, key: str) -> float:
        return float(sum(it.stats.get(key, 0.0) for it in self.iterations))

    def seq_lens(self) -> np.ndarray:
        return np.array([it.seq_len for it in self.iterations], dtype=np.int64)

    def runtimes(self) -> np.ndarray:
        return np.array([it.runtime for it in self.iterations])

    # ------------------------------------------------------------------
    def to_jsonable(self) -> dict:
        """Pure-JSON form (checkpoint manifests carry the partial log so a
        crash-resumed run re-extends the epoch bit-for-bit)."""
        return {"meta": dict(self.meta),
                "iterations": [[int(it.seq_len), float(it.runtime),
                                {k: float(v) for k, v in it.stats.items()}]
                               for it in self.iterations]}

    @classmethod
    def from_jsonable(cls, obj: Mapping) -> "EpochLog":
        log = cls(meta=dict(obj.get("meta", {})))
        for sl, rt, stats in obj.get("iterations", []):
            log.append(int(sl), float(rt), **stats)
        return log

    # ------------------------------------------------------------------
    def by_seq_len(self) -> "SLTable":
        """Aggregate to unique SLs (paper key obs. 5: iterations of one SL
        behave the same; we average out measurement noise)."""
        sls: Dict[int, List[IterationRecord]] = {}
        for it in self.iterations:
            sls.setdefault(it.seq_len, []).append(it)
        uniq = sorted(sls)
        counts = np.array([len(sls[s]) for s in uniq], dtype=np.int64)
        runtimes = np.array([np.mean([it.runtime for it in sls[s]])
                             for s in uniq])
        return SLTable(seq_lens=np.array(uniq, dtype=np.int64),
                       counts=counts, runtimes=runtimes)


@dataclass
class SLTable:
    """Unique sequence lengths with iteration counts and mean runtimes."""

    seq_lens: np.ndarray     # (U,) ascending
    counts: np.ndarray       # (U,) iterations per SL in the epoch
    runtimes: np.ndarray     # (U,) mean per-iteration runtime

    @property
    def num_unique(self) -> int:
        return int(len(self.seq_lens))

    @property
    def num_iterations(self) -> int:
        return int(self.counts.sum())

    @property
    def total_runtime(self) -> float:
        return float((self.counts * self.runtimes).sum())

    def runtime_of(self, sl: int) -> float:
        idx = int(np.searchsorted(self.seq_lens, sl))
        if idx >= len(self.seq_lens) or self.seq_lens[idx] != sl:
            raise KeyError(f"SL {sl} not in table")
        return float(self.runtimes[idx])
