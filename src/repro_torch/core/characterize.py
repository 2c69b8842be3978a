"""Characterizer: SeqPoint-driven epoch characterization, wallclock track.

``WallclockProvider`` really executes a training step per unique SL on the
given device (the paper's native-hardware profiling). The first call of a
step is its warmup (allocator growth, kernel loads, cuBLAS heuristics) —
the analog of XLA compilation in the JAX package: it is excluded from the
iteration cost and counted as profiling cost, which is what SeqPoint
amortizes (paper §IV-C2 / §VI-F).

The compiled-cost track (machine-model seconds from per-SL FLOPs and bytes)
has not been ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPointSet
from repro_torch.data.batching import BatchPlan
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class ProfileResult:
    runtime: float                       # per-iteration seconds
    stats: Dict[str, float] = field(default_factory=dict)
    profile_cost: float = 0.0            # seconds spent profiling this SL


class WallclockProvider:
    """Measure real per-iteration wallclock for a (model, batch) at a given
    padded SL. ``step_builder(sl) -> (fn, args)`` returns a step and its
    inputs; on a CUDA device each timed call is bracketed by
    ``torch.cuda.synchronize()``."""

    def __init__(self, step_builder: Callable[[int], Tuple[Callable, tuple]],
                 repeats: int = 3, device: DeviceLike = "cuda"):
        self.step_builder = step_builder
        self.repeats = repeats
        self.device = resolve_device(device)
        self.cache: Dict[int, ProfileResult] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def profile(self, sl: int) -> ProfileResult:
        if sl in self.cache:
            obs.metrics.counter("profile_cache_hits_total",
                                provider="wallclock").inc()
            return self.cache[sl]
        with obs.span("profile/wallclock", sl=sl):
            self._sync()
            t0 = time.perf_counter()
            with obs.span("profile/compile_warmup", sl=sl):
                fn, args = self.step_builder(sl)
                fn(*args)
                self._sync()                          # warmup
            warmup_cost = time.perf_counter() - t0
            times = []
            for _ in range(self.repeats):
                t0 = time.perf_counter()
                with obs.span("profile/measure", sl=sl):
                    fn(*args)
                    self._sync()
                times.append(time.perf_counter() - t0)
        res = ProfileResult(runtime=float(np.median(times)),
                            stats={"runtime_std": float(np.std(times))},
                            profile_cost=warmup_cost + sum(times))
        mreg = obs.metrics
        mreg.histogram("profile_step_time_s", sl=sl).observe(res.runtime)
        mreg.histogram("profile_cost_s", provider="wallclock",
                       sl=sl).observe(res.profile_cost)
        self.cache[sl] = res
        return res


# ---------------------------------------------------------------------------


def epoch_log_from_plan(plan: BatchPlan, provider,
                        machine: Optional[Any] = None) -> EpochLog:
    """Profile every unique SL in the plan, build the full epoch log (the
    paper's step (1): this is the expensive ground-truth pass)."""
    log = EpochLog(meta={"batch_size": plan.batch_size})
    uniq = sorted(set(int(s) for s in plan.padded_sls))
    results = {}
    for sl in uniq:
        results[sl] = (provider.profile(sl, machine)
                       if machine is not None else provider.profile(sl))
    for sl in plan.padded_sls:
        r = results[int(sl)]
        log.append(int(sl), r.runtime, **r.stats)
    return log


def project_on_config(points: SeqPointSet, provider,
                      machine: Optional[Any] = None,
                      kind: str = "total") -> float:
    """Profile ONLY the SeqPoint SLs on a (new) config and project (Eq. 1)."""
    def stat(sl: int) -> float:
        r = (provider.profile(sl, machine) if machine is not None
             else provider.profile(sl))
        return r.runtime
    return (points.project_total(stat) if kind == "total"
            else points.project_mean(stat))


def profiling_cost(provider, sls: List[int]) -> float:
    """Seconds spent profiling the given SLs (warmup + measure)."""
    total = 0.0
    for sl in sls:
        if hasattr(provider, "cache") and sl in provider.cache:
            total += provider.cache[sl].profile_cost
        elif hasattr(provider, "profile_costs"):
            total += provider.profile_costs.get(sl, 0.0)
    return total
