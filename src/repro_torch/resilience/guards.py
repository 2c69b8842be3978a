"""Training guardrails: finiteness checks, divergence detection, and a
per-SL step-time watchdog (a copy of ``repro.resilience.guards``).

Guards are cheap, synchronous checks on values the trainer already has in
hand (the step loss is materialized anyway for the EpochLog). A violation
raises a ``GuardViolation`` subclass; the trainer's recovery path turns that
into a rollback to the last good checkpoint rather than silently logging a
poisoned iteration into the EpochLog SeqPoint selection depends on.

The watchdog's baseline for a step is the running median of previous steps
*of the same padded SL* (paper key obs. 5: iterations of one SL behave the
same), falling back to the all-SL median for SLs not seen yet. The serve
engine uses it as the per-SL latency baseline of its hedging.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


class GuardViolation(RuntimeError):
    """A training-health invariant failed; the step must not be accepted."""

    def __init__(self, msg: str, *, step: Optional[int] = None):
        super().__init__(msg if step is None else f"step {step}: {msg}")
        self.step = step


class NonFiniteLossError(GuardViolation):
    pass


class DivergenceError(GuardViolation):
    pass


def check_finite(value: float, *, name: str = "loss",
                 step: Optional[int] = None) -> float:
    if not math.isfinite(value):
        raise NonFiniteLossError(f"{name} is {value!r}", step=step)
    return value


class DivergenceDetector:
    """EMA-based loss divergence detector.

    Tracks an exponential moving average of the loss; once warmed up, a loss
    above ``ratio * ema`` is suspicious, and ``patience`` *consecutive*
    suspicious steps raise ``DivergenceError``. Suspicious losses do not
    update the EMA, so a genuine divergence cannot drag the baseline up
    after itself and escape detection.
    """

    def __init__(self, *, ratio: float = 4.0, patience: int = 5,
                 warmup: int = 8, decay: float = 0.9):
        if ratio <= 1.0 or patience < 1:
            raise ValueError(f"need ratio > 1 and patience >= 1, got "
                             f"{ratio}, {patience}")
        self.ratio = ratio
        self.patience = patience
        self.warmup = warmup
        self.decay = decay
        self.reset()

    def reset(self) -> None:
        self.ema: Optional[float] = None
        self.steps_seen = 0
        self.streak = 0

    def update(self, loss: float, *, step: Optional[int] = None) -> None:
        self.steps_seen += 1
        if self.ema is None:
            self.ema = float(loss)
            return
        suspicious = (self.steps_seen > self.warmup
                      and loss > self.ratio * self.ema)
        if suspicious:
            self.streak += 1
            if self.streak >= self.patience:
                raise DivergenceError(
                    f"loss {loss:.4g} > {self.ratio:g}x EMA {self.ema:.4g} "
                    f"for {self.streak} consecutive steps", step=step)
            return
        self.streak = 0
        self.ema = self.decay * self.ema + (1.0 - self.decay) * float(loss)


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
