"""The SeqPoint selection mechanism (paper §V-C, Fig. 10).

  (1) log one epoch's unique SLs + iteration runtimes  ->  EpochLog/SLTable
  (2) bin SLs into k contiguous ranges (k=5 initially)
  (3) representative per bin: the SL whose mean runtime is closest to the
      bin's (iteration-weighted) average runtime
  (4) weight := number of iterations in the bin
  (5) predicted epoch statistic := sum_i w_i * s_i        (paper Eq. 1)
  (6) if |predicted - actual| / actual > e: k += 1, goto (2)

If the epoch has at most ``n_threshold`` unique SLs, every unique SL is a
SeqPoint with weight = its frequency (projection is then exact).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profile import EpochLog, SLTable


@dataclass(frozen=True)
class SeqPoint:
    seq_len: int
    weight: float              # iterations represented
    runtime: float             # profiled per-iteration statistic at selection


@dataclass
class SeqPointSet:
    points: List[SeqPoint]
    k: int                     # bins used (0 = all-unique mode)
    predicted: float           # Eq. 1 applied to the selection statistic
    actual: float              # logged epoch total
    error: float               # |predicted-actual|/actual
    method: str = "seqpoint"
    meta: dict = field(default_factory=dict)

    @property
    def seq_lens(self) -> List[int]:
        return [p.seq_len for p in self.points]

    @property
    def weights(self) -> np.ndarray:
        return np.array([p.weight for p in self.points])

    @property
    def num_points(self) -> int:
        return len(self.points)

    # --- paper Eq. 1 -------------------------------------------------------
    def project_total(self, stat: Callable[[int], float]) -> float:
        """Weighted sum of a per-iteration statistic measured only at the
        SeqPoint SLs (e.g. runtime on a *different* hardware config)."""
        return float(sum(p.weight * stat(p.seq_len) for p in self.points))

    def project_mean(self, stat: Callable[[int], float]) -> float:
        """Weight-normalized projection for ratio statistics (paper §V-C:
        throughput, IPC, ...)."""
        w = self.weights.sum()
        return self.project_total(stat) / max(w, 1e-12)


def _bin_edges(table: SLTable, k: int) -> np.ndarray:
    lo, hi = int(table.seq_lens[0]), int(table.seq_lens[-1])
    return np.linspace(lo, hi + 1, k + 1)


def _select_with_k(table: SLTable, k: int) -> List[SeqPoint]:
    edges = _bin_edges(table, k)
    bins = np.clip(np.digitize(table.seq_lens, edges) - 1, 0, k - 1)
    points: List[SeqPoint] = []
    for b in range(k):
        mask = bins == b
        if not mask.any():
            continue
        sls = table.seq_lens[mask]
        counts = table.counts[mask]
        runtimes = table.runtimes[mask]
        # iteration-weighted average runtime of the bin
        avg = float((counts * runtimes).sum() / counts.sum())
        rep = int(np.argmin(np.abs(runtimes - avg)))
        points.append(SeqPoint(seq_len=int(sls[rep]),
                               weight=float(counts.sum()),
                               runtime=float(runtimes[rep])))
    return points


def _eq1(points: Sequence[SeqPoint]) -> float:
    return float(sum(p.weight * p.runtime for p in points))


def select_seqpoints(log: EpochLog | SLTable, *,
                     n_threshold: int = 10,
                     k_init: int = 5,
                     error_threshold: float = 0.02,
                     k_max: int = 64) -> SeqPointSet:
    table = log.by_seq_len() if isinstance(log, EpochLog) else log
    actual = table.total_runtime

    if table.num_unique <= n_threshold:
        points = [SeqPoint(int(s), float(c), float(r))
                  for s, c, r in zip(table.seq_lens, table.counts,
                                     table.runtimes)]
        pred = _eq1(points)
        return SeqPointSet(points, k=0, predicted=pred, actual=actual,
                           error=abs(pred - actual) / max(actual, 1e-12),
                           meta={"mode": "all-unique", "converged": True})

    best: Optional[SeqPointSet] = None
    k = k_init
    while k <= min(k_max, table.num_unique):
        points = _select_with_k(table, k)
        pred = _eq1(points)
        err = abs(pred - actual) / max(actual, 1e-12)
        cand = SeqPointSet(points, k=k, predicted=pred, actual=actual,
                           error=err,
                           meta={"mode": "binned", "converged": True})
        if best is None or err < best.error:
            best = cand
        if err <= error_threshold:
            return cand
        k += 1
    assert best is not None
    best.meta["converged"] = False
    return best
