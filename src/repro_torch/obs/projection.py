"""SeqPoint projection-error monitoring, a port of ``repro.obs.projection``:
check the projections against the ground truth they claim to predict.

Daydream (2020)'s lesson is that an optimization-efficacy estimate is only
trustworthy once validated against instrumented execution. Two validators
live here:

* ``ProjectionMonitor`` — given a ``SeqPointSet`` selected earlier, watch a
  live ``EpochLog`` (or a stream of ``observe(sl, runtime)`` calls) and
  report the running projected-vs-measured epoch runtime plus per-SL
  residuals. Each observed iteration is predicted by its nearest SeqPoint's
  profiled runtime — exactly the substitution Eq. 1 makes, now checked
  online instead of assumed.

* ``cell_collective_projection`` / ``collective_projection_report`` — the
  analytic communication model (``tp_activation_wire_bytes`` +
  ``dp_grad_wire_bytes``) against *measured* collective bytes in a
  ``perfmodel.hlo.CollectiveStats``, per dry-run cell. The residual between
  the two is the model's blind spot (e.g. ZeRO param gathers), reported per
  collective kind so it is attributable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.configs.base import (
    ModelConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
)
from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPointSet
from repro_torch.dist.compression import wire_bytes_per_elem
from repro_torch.dist.sharding import tp_activation_wire_bytes
from repro_torch.perfmodel.hlo import CollectiveStats
from repro_torch.perfmodel.model_flops import param_count


# --------------------------------------------------------------------------
# live epoch-runtime projection


@dataclass(frozen=True)
class SLResidual:
    seq_len: int
    iterations: int
    measured_mean: float       # mean measured per-iteration runtime
    predicted: float           # nearest-SeqPoint profiled runtime
    residual: float            # measured_mean - predicted
    rel_error: float


@dataclass
class ProjectionReport:
    iterations: int
    measured_total: float      # sum of observed runtimes
    projected_total: float     # same iterations priced by their SeqPoints
    rel_error: float           # |projected - measured| / measured
    eq1_predicted: float       # full-epoch Eq. 1 number from selection time
    per_sl: List[SLResidual] = field(default_factory=list)

    def worst_sl(self) -> Optional[SLResidual]:
        if not self.per_sl:
            return None
        return max(self.per_sl, key=lambda r: abs(r.rel_error))


class ProjectionMonitor:
    """Running projected-vs-measured check for one ``SeqPointSet``."""

    def __init__(self, seqpoints: SeqPointSet):
        if not seqpoints.points:
            raise ValueError("SeqPointSet has no points")
        self.seqpoints = seqpoints
        pts = sorted(seqpoints.points, key=lambda p: p.seq_len)
        self._sp_sls = np.array([p.seq_len for p in pts], dtype=np.int64)
        self._sp_rts = np.array([p.runtime for p in pts])
        # per observed SL: [count, measured_sum]
        self._by_sl: Dict[int, List[float]] = {}
        self.measured_total = 0.0
        self.projected_total = 0.0
        self.iterations = 0

    def predict(self, sl: int) -> float:
        """Per-iteration runtime the projection assigns to ``sl``: the
        profiled runtime of the nearest SeqPoint (its bin representative)."""
        idx = int(np.argmin(np.abs(self._sp_sls - int(sl))))
        return float(self._sp_rts[idx])

    def observe(self, sl: int, runtime: float) -> None:
        sl = int(sl)
        acc = self._by_sl.setdefault(sl, [0.0, 0.0])
        acc[0] += 1
        acc[1] += runtime
        self.measured_total += runtime
        self.projected_total += self.predict(sl)
        self.iterations += 1

    def observe_log(self, log: EpochLog) -> None:
        for it in log.iterations:
            self.observe(it.seq_len, it.runtime)

    def report(self) -> ProjectionReport:
        per_sl = []
        for sl in sorted(self._by_sl):
            n, total = self._by_sl[sl]
            mean = total / n
            pred = self.predict(sl)
            per_sl.append(SLResidual(
                seq_len=sl, iterations=int(n), measured_mean=mean,
                predicted=pred, residual=mean - pred,
                rel_error=(mean - pred) / max(mean, 1e-12)))
        return ProjectionReport(
            iterations=self.iterations,
            measured_total=self.measured_total,
            projected_total=self.projected_total,
            rel_error=abs(self.projected_total - self.measured_total)
            / max(self.measured_total, 1e-12),
            eq1_predicted=self.seqpoints.predicted,
            per_sl=per_sl)


# --------------------------------------------------------------------------
# analytic-vs-measured collective bytes (per dry-run cell)


def analytic_wire_bytes(cfg: ModelConfig, shape: ShapeConfig, *,
                        parallelism: str, dp_degree: int, tp_degree: int,
                        grad_compression: str = "none",
                        grad_dtype_bytes: float = 4.0,
                        micro_reduces: int = 1,
                        dp_reduce_elems: Optional[float] = None
                        ) -> Dict[str, float]:
    """The two analytic per-step communication terms SeqPoint projects.

    ``grad_dtype_bytes`` is the native gradient width (2 for bf16 compute,
    relevant only when ``grad_compression`` is "none"); ``micro_reduces``
    is the parameter-sized reductions per optimizer step (1 for plain DP,
    the microbatch count under ZeRO-3, where each microbatch's
    reduce-scatter goes on the wire immediately). ``dp_reduce_elems`` is
    the per-device gradient element count actually on the DP ring
    (``dist.sharding.dp_grad_reduce_elems`` from the real spec tree);
    without it the full parameter count is assumed, which overstates the
    term by the model degree when grads are TP-sharded.
    """
    training = shape.step == StepKind.TRAIN
    dp = 0.0
    if training and dp_degree > 1:
        elems = param_count(cfg, active=False) \
            if dp_reduce_elems is None else dp_reduce_elems
        buf = elems * wire_bytes_per_elem(grad_compression,
                                          grad_dtype_bytes)
        dp = 2.0 * (dp_degree - 1) / dp_degree * buf \
            * max(1, int(micro_reduces))
    # decode moves one token through the stack, not shape.seq_len
    sl = 1 if shape.step == StepKind.DECODE else shape.seq_len
    tp = tp_activation_wire_bytes(cfg, shape.global_batch, sl, tp_degree,
                                  training=training)
    return {"dp_grad": dp, "tp_activation": tp, "total": dp + tp}


# kinds the analytic model claims to cover: gradient all-reduce (or its
# ZeRO reduce-scatter + all-gather decomposition) + TP activation all-reduce
_REDUCE_KINDS = ("all-reduce", "reduce-scatter", "all-gather")
# kinds the analytic terms actually price: both the DP grad reduce and the
# TP activation reduce lower to all-reduces. ZeRO param all-gathers and
# halo collective-permutes are measured and attributed per kind but are
# deliberately outside the model — ``rel_error_claimed`` is the residual
# on the claimed kinds only, and is what the dryrun summary gates on.
_CLAIMED_KINDS = ("all-reduce",)


def cell_collective_projection(cfg: ModelConfig, shape: ShapeConfig,
                               run: RunConfig,
                               measured: CollectiveStats, *,
                               layers_counted: Optional[int] = None,
                               micro_counted: Optional[int] = None,
                               dp_reduce_elems: Optional[float] = None
                               ) -> Dict[str, Any]:
    """Analytic-vs-measured wire bytes for one dry-run cell.

    ``measured`` holds one device's collectives (the reference parses
    them out of the per-device SPMD module), so the analytic
    terms are normalized to per-device: the TP activation number divides by
    the data degree (the residual is batch-sharded over ``dp``); the DP
    gradient number already is per-device ring traffic. ``layers_counted``
    handles compile-mode rolled scans, where the measurement holds one scan
    body (one interleave period) rather than the full depth — pass
    ``cfg.interleave_period`` there, leave None for extrapolated
    (roofline) stats that already cover every layer. ``micro_counted`` is
    the same normalization for the microbatch scan: the number of
    microbatch bodies present in the measurement (1 for a rolled
    compile-mode scan; None when the stats cover every microbatch).
    ``dp_reduce_elems`` is forwarded to ``analytic_wire_bytes``.
    """
    dp_degree = (run.mesh.num_devices if run.parallelism == "dp_only"
                 else run.mesh.data_degree)
    tp_degree = run.mesh.model_degree if run.parallelism == "tp" else 1
    # bf16 compute keeps bf16 grads on the wire when uncompressed; ZeRO-3
    # reduce-scatters every microbatch (no local accumulation possible)
    grad_dtype_bytes = 2.0 if run.compute_dtype == "bfloat16" else 4.0
    micro_reduces = run.microbatches \
        if (run.fsdp and run.zero_stage >= 3) else 1
    micro_in_measurement = micro_reduces if micro_counted is None \
        else min(micro_reduces, int(micro_counted))
    analytic = analytic_wire_bytes(
        cfg, shape, parallelism=run.parallelism, dp_degree=dp_degree,
        tp_degree=tp_degree,
        grad_compression=run.optimizer.grad_compression,
        grad_dtype_bytes=grad_dtype_bytes,
        micro_reduces=micro_in_measurement,
        dp_reduce_elems=dp_reduce_elems)
    depth_frac = 1.0 if layers_counted is None \
        else layers_counted / max(cfg.num_layers, 1)
    a_tp = analytic["tp_activation"] / max(dp_degree, 1) * depth_frac
    a_dp = analytic["dp_grad"]
    a_total = a_dp + a_tp
    measured_total = float(measured.wire_bytes)
    measured_reduce = float(measured.wire_bytes_of(_REDUCE_KINDS))
    measured_claimed = float(measured.wire_bytes_of(_CLAIMED_KINDS))
    return {
        "analytic_dp_bytes": a_dp,
        "analytic_tp_bytes": a_tp,
        "analytic_wire_bytes": a_total,
        "layers_counted": layers_counted or cfg.num_layers,
        "measured_wire_bytes": measured_total,
        "measured_reduce_wire_bytes": measured_reduce,
        "measured_by_kind": measured.to_dict(),
        "rel_error": abs(a_total - measured_total)
        / max(measured_total, 1.0)
        if (a_total or measured_total) else 0.0,
        "rel_error_reduce": abs(a_total - measured_reduce)
        / max(measured_reduce, 1.0)
        if (a_total or measured_reduce) else 0.0,
        "measured_claimed_wire_bytes": measured_claimed,
        "rel_error_claimed": abs(a_total - measured_claimed)
        / max(measured_claimed, 1.0)
        if (a_total or measured_claimed) else 0.0,
        "dp_degree": dp_degree,
        "tp_degree": tp_degree,
        "grad_dtype_bytes": grad_dtype_bytes,
        "micro_reduces": micro_reduces,
        "micro_counted": micro_in_measurement,
        "dp_reduce_elems": dp_reduce_elems,
    }


def collective_projection_report(records: Iterable[Dict[str, Any]], *,
                                 error_bound: Optional[float] = None
                                 ) -> Dict[str, Any]:
    """Aggregate per-cell ``projection`` entries from dry-run records.

    Returns ``{"cells": [...], "max_rel_error": x, "within_bound": bool}``;
    ``within_bound`` is True when no cell exceeds ``error_bound`` (always
    True when no bound is given).
    """
    cells: List[Dict[str, Any]] = []
    for rec in records:
        proj = rec.get("projection")
        if proj is None or rec.get("status") not in (None, "ok"):
            continue
        cells.append({
            "cell": f"{rec.get('arch')}/{rec.get('shape')}"
                    f"@{rec.get('mesh', '?')}",
            **proj,
        })
    max_err = max((c["rel_error"] for c in cells), default=0.0)
    # the bound applies to the claimed-kind residual (all-reduces), the
    # number the analytic model is accountable for
    max_claimed = max(
        (c.get("rel_error_claimed", c["rel_error"]) for c in cells),
        default=0.0)
    return {
        "cells": cells,
        "num_cells": len(cells),
        "max_rel_error": max_err,
        "max_rel_error_claimed": max_claimed,
        "error_bound": error_bound,
        "within_bound": error_bound is None or max_claimed <= error_bound,
    }
