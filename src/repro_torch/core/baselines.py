"""SeqPoint alternatives evaluated in the paper (§VI-C).

  frequent — the most frequently occurring SL, projected over all iterations
  median   — the iteration-median SL
  worst    — the single SL with the worst-case projection error (the bound
             on arbitrarily picking one iteration, paper Figs. 11-16)
  prior    — Zhu et al. [IISWC'18]: 50 contiguous iterations after a warmup,
             mean runtime x iteration count

All return ``SeqPointSet`` so the projection machinery (Eq. 1) is shared.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPoint, SeqPointSet


def _single(log: EpochLog, sl: int, method: str) -> SeqPointSet:
    table = log.by_seq_len()
    n = table.num_iterations
    rt = table.runtime_of(sl)
    points = [SeqPoint(seq_len=int(sl), weight=float(n), runtime=rt)]
    pred = n * rt
    actual = table.total_runtime
    return SeqPointSet(points, k=1, predicted=pred, actual=actual,
                       error=abs(pred - actual) / max(actual, 1e-12),
                       method=method)


def frequent(log: EpochLog) -> SeqPointSet:
    table = log.by_seq_len()
    sl = int(table.seq_lens[int(np.argmax(table.counts))])
    return _single(log, sl, "frequent")


def median(log: EpochLog) -> SeqPointSet:
    sls = np.sort(log.seq_lens())
    sl = int(sls[len(sls) // 2])
    return _single(log, sl, "median")


def worst(log: EpochLog) -> SeqPointSet:
    """Upper-bounds the error of picking one arbitrary iteration."""
    table = log.by_seq_len()
    n, actual = table.num_iterations, table.total_runtime
    errs = np.abs(n * table.runtimes - actual)
    sl = int(table.seq_lens[int(np.argmax(errs))])
    return _single(log, sl, "worst")


def prior(log: EpochLog, *, num_iters: int = 50,
          warmup: int = 50) -> SeqPointSet:
    """Sampling-based prior work: profile ``num_iters`` contiguous
    iterations after ``warmup`` — whatever SLs happen to be there."""
    its = log.iterations[warmup:warmup + num_iters]
    if not its:
        its = log.iterations[:num_iters]
    n = log.num_iterations
    scale = n / len(its)
    points = [SeqPoint(seq_len=it.seq_len, weight=scale, runtime=it.runtime)
              for it in its]
    pred = float(sum(p.weight * p.runtime for p in points))
    actual = log.total_runtime
    return SeqPointSet(points, k=len(points), predicted=pred, actual=actual,
                       error=abs(pred - actual) / max(actual, 1e-12),
                       method="prior")


ALL_BASELINES = {"frequent": frequent, "median": median, "worst": worst,
                 "prior": prior}
