"""Seeded, deterministic fault injection for chaos drills.

A copy of ``repro.resilience.faults``: the plan, ``check`` and ``fire``,
and the trainer's ``corrupt`` and ``delay`` hooks.

SeqPoint projects a whole run from a few profiled iterations, so the
projection is only trustworthy if the measured run survives the faults a
real fleet throws at it: flaky data loaders, NaN losses, failing checkpoint
disks, preemptions, stragglers. This module is the single switchboard for
*simulating* those faults deterministically, so a chaos run is exactly
reproducible (same plan + seed => same faults at the same steps).

A plan is a comma-separated spec string, env-driven like ``REPRO_OBS_DIR``:

    REPRO_FAULTS="data_fetch@2,nan_loss@5,preempt@9,decode%0.1:times=2"
    REPRO_FAULTS_SEED=0

Each spec is ``point[@step][%prob][:opt=val]*``:

    point@step          fire when the instrumented point reaches ``step``
    point%prob          fire each call with probability ``prob`` (seeded by
                        (seed, point, call index), so replays are identical)
    :times=N            max firings (default 1 for @step, unlimited for %p)
    :delay=S            magnitude for ``straggler`` / ``peer_slow`` (seconds)
    :host=H             target host/replica for the multi-host points

Instrumented points (the serve engine and its scheduler reach ``decode``
and ``peer_slow``; the others belong to the trainer):

    data_fetch      transient error from the data iterator (retryable)
    nan_loss        corrupts the step loss to NaN (guard -> rollback)
    ckpt_save       transient I/O failure inside the checkpoint writer
    ckpt_restore    transient I/O failure at checkpoint load
    ckpt_corrupt    silently flips bytes in arrays.npz *after* the sha256 is
                    recorded (media corruption; caught at restore-verify)
    preempt         simulated preemption mid-step (PreemptionFault)
    straggler       artificial slowdown added to the measured step time
    decode          transient failure of one serve decode call (retryable)
    peer_loss       host ``:host=H`` stops heartbeating permanently
                    (ClusterMonitor confirms the loss -> elastic re-mesh)
    peer_slow       host/replica ``:host=H`` runs ``:delay=S`` late: a missed
                    heartbeat in the trainer, a per-decode-call slowdown in
                    the serve engine (hedging re-issues the batch)
    mesh_partition  hosts >= ``:host=H`` become unreachable from host 0's
                    side of the partition (all confirmed lost together)

When no plan is installed every hook is a single ``is None`` check, so the
instrumented hot paths cost nothing in production.
"""
from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs


class FaultError(RuntimeError):
    """Base class for injected faults."""

    def __init__(self, point: str, index: int):
        super().__init__(f"injected fault at {point!r} (index {index})")
        self.point = point
        self.index = index


class TransientFault(FaultError):
    """A fault that a retry is expected to clear (flaky disk, loader)."""


class PreemptionFault(FaultError):
    """Simulated fleet preemption: the step in flight never completes."""


@dataclass(frozen=True)
class FaultSpec:
    point: str
    step: Optional[int] = None      # fire at this step/call index
    prob: float = 0.0               # else: per-call probability
    times: int = 1                  # max firings; <= 0 means unlimited
    delay: float = 0.05             # straggler/peer_slow magnitude (seconds)
    host: int = 0                   # target host/replica for peer points

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        head, *opts = text.strip().split(":")
        step: Optional[int] = None
        prob = 0.0
        if "@" in head:
            point, s = head.split("@", 1)
            step = int(s)
            times = 1
        elif "%" in head:
            point, p = head.split("%", 1)
            prob = float(p)
            times = 0
        else:
            point, times = head, 1
        kw: Dict[str, float] = {}
        for opt in opts:
            k, v = opt.split("=", 1)
            if k == "times":
                times = int(v)
            elif k == "delay":
                kw["delay"] = float(v)
            elif k == "host":
                kw["host"] = int(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in {text!r}")
        return cls(point=point, step=step, prob=prob, times=times, **kw)


class FaultPlan:
    """A set of FaultSpecs plus per-spec firing counters (thread-safe)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._fired = [0] * len(self.specs)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = [FaultSpec.parse(t) for t in text.split(",") if t.strip()]
        return cls(specs, seed=seed)

    def __repr__(self) -> str:
        return f"FaultPlan({self.specs!r}, seed={self.seed})"

    def _roll(self, spec: FaultSpec, index: int) -> bool:
        # deterministic per (seed, point, index): identical across replays
        # and across processes, which is what makes chaos runs debuggable
        key = f"{self.seed}:{spec.point}:{index}".encode()
        rng = np.random.RandomState(zlib.crc32(key) & 0x7FFFFFFF)
        return bool(rng.random_sample() < spec.prob)

    def check(self, point: str, index: int) -> Optional[FaultSpec]:
        """Return the spec that fires at (point, index), consuming one of
        its ``times`` budget, or None."""
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.times > 0 and self._fired[i] >= spec.times:
                    continue
                hit = (index == spec.step) if spec.step is not None \
                    else self._roll(spec, index)
                if hit:
                    self._fired[i] += 1
                    return spec
        return None


# --------------------------------------------------------------------------
# process-global plan (absent by default: every hook is then a no-op)

_PLAN: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or remove, with None) the global plan; returns the old one."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    return prev


def current() -> Optional[FaultPlan]:
    return _PLAN


def active() -> bool:
    return _PLAN is not None


def check(point: str, index: int) -> Optional[FaultSpec]:
    plan = _PLAN
    if plan is None:
        return None
    spec = plan.check(point, index)
    if spec is not None:
        obs.metrics.counter("faults_injected_total", point=point).inc()
        obs.event("fault_injected", point=point, index=index,
                  step=spec.step, prob=spec.prob)
    return spec


def fire(point: str, index: int) -> None:
    """Raise the point's fault class if a spec fires (else no-op)."""
    if check(point, index) is not None:
        exc = PreemptionFault if point == "preempt" else TransientFault
        raise exc(point, index)


def corrupt(point: str, index: int, value: float) -> float:
    """Return NaN instead of ``value`` if a spec fires."""
    if check(point, index) is not None:
        return float("nan")
    return value


def delay(point: str, index: int) -> float:
    """Seconds of artificial slowdown to add (0.0 when nothing fires)."""
    spec = check(point, index)
    return float(spec.delay) if spec is not None else 0.0


# opt-in via environment, mirroring REPRO_OBS_DIR: REPRO_FAULTS=<plan spec>
# (+ REPRO_FAULTS_SEED) arms the plan for any entrypoint without code edits.
_env_plan = os.environ.get("REPRO_FAULTS")
if _env_plan:
    install(FaultPlan.parse(
        _env_plan, seed=int(os.environ.get("REPRO_FAULTS_SEED", "0"))))
