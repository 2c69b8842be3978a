"""Characterizer: SeqPoint-driven epoch characterization.

Two profiling backends feed the same selection and projection code:

* ``WallclockProvider`` really executes a training step per unique SL on the
given device (the paper's native-hardware profiling). The first call of a
step is its warmup (allocator growth, kernel loads, cuBLAS heuristics) —
the analog of XLA compilation in the JAX package: it is excluded from the
iteration cost and counted as profiling cost, which is what SeqPoint
amortizes (paper §IV-C2 / §VI-F).
* ``CountedCostProvider`` — one step per unique SL run under operation
  counters (FLOPs and bytes); an analytic machine model (the H100 and the
  paper-analog configs #2-#5, ``perfmodel/machine.py``) turns the counts
  into per-iteration seconds: the paper's hardware-config sensitivity study
  (Table II) on machines the port does not have.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import obs
from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPointSet
from repro_torch.data.batching import BatchPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.perfmodel.machine import MachineConfig


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


_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
           torch.bool: "pred"}


def _shape(dtype: torch.dtype, shape: Tuple[int, ...]) -> str:
    """HLO-style ``f32[16,256]``, as the JAX package's histogram keys."""
    dims = ",".join(str(n) for n in shape)
    return f"{_DTYPES.get(dtype, str(dtype).split('.')[-1])}[{dims}]"


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class _OpCounter(TorchDispatchMode):
    """Every aten op dispatched under it: FLOPs by ``FlopCounterMode``'s
    own formulas (its ``flop_registry``: matmuls, convolutions, attention;
    other ops count none), operand and result bytes (view and alias ops
    count none), and a histogram by op and result shapes. It reads the
    registry itself: nesting ``FlopCounterMode``'s own mode costs 1.5-2.2
    times the host time an op (``examples/bench_counting_torch.py``, on a
    CPU and an H100), which the millions of ops of a full-width epoch
    feel.
    ``tests/test_torch_ds2.py`` holds the two totals equal."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        results = _tensors(out)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            operands = _tensors((args, *kwargs.values()))
            self.bytes += sum(t.nbytes for t in operands + results)
        self.ops[packet.__name__,
                 tuple((t.dtype, tuple(t.shape)) for t in results)] += 1
        return out

    def histogram(self) -> Dict[str, int]:
        """Keyed ``"{op}:{result shape}"``, tuple results in parentheses."""
        out: Dict[str, int] = {}
        for (name, results), n in self.ops.items():
            shapes = [_shape(*r) for r in results]
            key = shapes[0] if len(shapes) == 1 else f"({','.join(shapes)})"
            out[f"{name}:{key}"] = n
        return out


def count_costs(fn: Callable, *args) -> Tuple[float, float, Dict[str, int]]:
    """Run ``fn(*args)`` once; return its FLOPs, the bytes its aten ops
    read and write, and its op histogram (``_OpCounter``)."""
    counter = _OpCounter()
    with counter:
        fn(*args)
    return float(counter.flops), float(counter.bytes), counter.histogram()


class CountedCostProvider:
    """Per-SL counted cost -> machine-model seconds: the port's counterpart
    of ``repro.core.characterize.CompiledCostProvider``, which reads XLA's
    ``cost_analysis()``. ``count_builder(sl) -> (fn, args)`` gives a
    training step; ``costs(sl)`` runs it once under ``count_costs`` and
    keeps its op histogram (the analog of the reference's compiled-HLO
    histogram) in ``op_histograms``. One device: no collective bytes.
    ``profile`` prices the counts with the no-overlap model
    (``MachineConfig.step_time_sum``), as the reference's reproduction
    does: under the roofline model every SL's speedup is the same bound's
    and the sensitivity study degenerates.

    The counts are not the reference's, by construction:

    * every timestep of every recurrent layer runs and is counted. XLA
      counts a ``lax.scan`` body once whatever its trip count, so the
      reference's FLOPs and bytes hold one timestep of each LSTM and GRU
      and miss most of their SL dependence;
    * the bytes are unfused eager traffic, every aten op's operands and
      results, where XLA counts its fusions' traffic.

    The step runs plain PyTorch ops (GNMT's plain cell), which is what the
    reference counts, its jnp model and never its kernel; the LSTM cell's
    kernel op would count its registered operations (the bias's B 4H on
    top of the GEMM's) in place of the plain cell's matmul."""

    def __init__(self, count_builder: Callable[[int], Tuple[Callable, tuple]],
                 machine: MachineConfig, device: DeviceLike = "cuda"):
        self.count_builder = count_builder
        self.machine = machine
        self.device = resolve_device(device)
        self.cost_cache: Dict[int, Tuple[float, float, float]] = {}
        self.profile_costs: Dict[int, float] = {}
        self.op_histograms: Dict[int, Dict[str, int]] = {}

    def costs(self, sl: int) -> Tuple[float, float, float]:
        if sl not in self.cost_cache:
            t0 = time.perf_counter()
            with obs.span("profile/counted_cost", sl=sl):
                fn, args = self.count_builder(sl)
                flops, bts, ops = count_costs(fn, *args)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.cost_cache[sl] = (flops, bts, 0.0)
            self.op_histograms[sl] = ops
            self.profile_costs[sl] = time.perf_counter() - t0
            obs.metrics.histogram("profile_cost_s", provider="counted",
                                  sl=sl).observe(self.profile_costs[sl])
        else:
            obs.metrics.counter("profile_cache_hits_total",
                                provider="counted").inc()
        return self.cost_cache[sl]

    def profile(self, sl: int,
                machine: Optional[MachineConfig] = None) -> ProfileResult:
        flops, bts, coll = self.costs(sl)
        m = machine or self.machine
        return ProfileResult(runtime=m.step_time_sum(flops, bts, coll),
                             stats={"flops": flops, "bytes": bts,
                                    "coll_bytes": coll},
                             profile_cost=self.profile_costs.get(sl, 0.0))


# ---------------------------------------------------------------------------


def epoch_log_from_plan(plan: BatchPlan, provider,
                        machine: Optional[MachineConfig] = None) -> EpochLog:
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
                      machine: Optional[MachineConfig] = None,
                      kind: str = "total") -> float:
    """Profile ONLY the SeqPoint SLs on a (new) config and project (Eq. 1)."""
    def stat(sl: int) -> float:
        r = (provider.profile(sl, machine) if machine is not None
             else provider.profile(sl))
        return r.runtime
    return (points.project_total(stat) if kind == "total"
            else points.project_mean(stat))


def profiling_cost(provider, sls: List[int]) -> float:
    """Seconds spent profiling the given SLs (warmup + measure, or the
    counting pass)."""
    total = 0.0
    for sl in sls:
        if hasattr(provider, "cache") and sl in provider.cache:
            total += provider.cache[sl].profile_cost
        elif hasattr(provider, "profile_costs"):
            total += provider.profile_costs.get(sl, 0.0)
    return total
