"""Per-SL step-time watchdog (a copy of ``repro.resilience.guards``'
``StepTimeWatchdog``; the training guards come with the training slice).

The baseline for a step is the running median of previous steps *of the
same padded SL* (paper key obs. 5: iterations of one SL behave the same),
falling back to the all-SL median for SLs not seen yet. The serve engine
uses it as the per-SL latency baseline of its hedging.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class WatchdogVerdict:
    sl: int
    dt: float
    baseline: Optional[float]       # None while no baseline exists yet
    is_straggler: bool


class StepTimeWatchdog:
    """Per-SL running-median step-time baseline with straggler verdicts.

    ``observe`` judges a step against the median of earlier same-SL steps
    (all-SL median as cold-start fallback), then folds it into the
    baselines. On a real fleet a straggler verdict triggers hot-spare
    promotion; here the trainer counts it and emits an obs event.
    """

    def __init__(self, factor: float = 3.0):
        self.factor = factor
        self._by_sl: Dict[int, List[float]] = {}
        self._all: List[float] = []

    def baseline(self, sl: int) -> Optional[float]:
        pool = self._by_sl.get(sl) or self._all
        return float(np.median(pool)) if pool else None

    def observe(self, sl: int, dt: float) -> WatchdogVerdict:
        baseline = self.baseline(sl)
        verdict = WatchdogVerdict(
            sl=sl, dt=dt, baseline=baseline,
            is_straggler=(baseline is not None
                          and dt > self.factor * baseline))
        self._by_sl.setdefault(sl, []).append(dt)
        self._all.append(dt)
        return verdict
