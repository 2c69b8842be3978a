"""End-to-end SeqPoint reproduction on the paper's networks (GNMT, DS2), in
PyTorch.

Two tracks, as ``repro.core.reproduction``:

* Track W (wallclock): really run GNMT/DS2 training iterations per unique
  padded SL on the device; SeqPoint and every baseline project the epoch's
  total training time (paper Figs. 11/12, config #1).
* Track A (analytic machine configs): per-SL counted FLOPs and bytes drive
  the five paper-analog hardware configs (Table II), config #1 the H100
  (``perfmodel/machine.py``); SeqPoints selected on config #1 project times
  and speedups on configs #2-#5 (Figs. 11-16). The counts cover every
  timestep, where the reference's ``cost_analysis`` counts one
  (``CountedCostProvider``).

Also measured: per-SL profiling cost (warmup + measure seconds) — the
quantity SeqPoint reduces (paper §VI-F) — and, for four SLs near and far,
a histogram of the aten ops a step dispatches, keyed by op and result
shape (the Fig. 8 analog).

Results cache to results/repro_torch_<network><tag>.json, in the JAX
package's schema plus a ``device`` key.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.core.baselines import ALL_BASELINES
from repro_torch.core.characterize import (
    CountedCostProvider,
    WallclockProvider,
    epoch_log_from_plan,
    profiling_cost,
    project_on_config,
)
from repro_torch.core.clustering import kmeans_seqpoints
from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPointSet, select_seqpoints
from repro_torch.data.batching import BatchPlan, plan_epoch
from repro_torch.data.synthetic import IWSLT_LIKE, LIBRISPEECH_LIKE
from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.models.rnn import DS2, GNMT, DS2Config, GNMTConfig
from repro_torch.perfmodel.machine import PAPER_CONFIGS

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results")

# the JAX package's reduced GNMT and DS2 for its reproduction
SMALL_GNMT = GNMTConfig(vocab_size=2048, d_model=96, num_enc_uni=2,
                        num_dec=2)
SMALL_DS2 = DS2Config(num_freq=64, conv_channels=8, d_h=64, num_gru=2)


# ---------------------------------------------------------------------------
# network setups


def _train_step(model, batch: dict, **loss_kwargs):
    params = list(model.parameters())

    def step(b):
        # the update is computed and dropped, as the JAX step returns new
        # params that are never fed back: every repeat starts from the
        # same parameters
        loss, _ = model.loss(b, **loss_kwargs)
        grads = torch.autograd.grad(loss, params)
        return loss, [p.detach() - 1e-4 * g for p, g in zip(params, grads)]

    return step, (batch,)


def _gnmt_setup(device: torch.device,
                model_config: Optional[GNMTConfig] = None) -> dict:
    model = GNMT(model_config or SMALL_GNMT, seed=0, device=device)
    if device.type == "cuda":
        lstm_kernel.build()       # nvcc before profiling, not in its cost

    def step_builder(sl: int):
        return _train_step(model, model.make_batch(sl, 16, sl, sl))

    def count_builder(sl: int):
        # the plain cell, as the reference counts its jnp model (the
        # kernel's op would count its own registered operations)
        return _train_step(model, model.make_batch(sl, 16, sl, sl),
                           use_kernel=False)

    return dict(step_builder=step_builder, count_builder=count_builder,
                dist=IWSLT_LIKE, batch_size=64, granularity=4,
                sort_first=False, samples=6400)


def _ds2_setup(device: torch.device,
               model_config: Optional[DS2Config] = None) -> dict:
    model = DS2(model_config or SMALL_DS2, seed=0, device=device)

    def step_builder(sl: int):
        return _train_step(model, model.make_batch(sl, 8, sl))

    # DS2 sorts inputs in the first epoch (paper §VI-D artifact)
    return dict(step_builder=step_builder, count_builder=step_builder,
                dist=LIBRISPEECH_LIKE, batch_size=32, granularity=64,
                sort_first=True, samples=3200)


SETUPS: Dict[str, Callable[..., dict]] = {"gnmt": _gnmt_setup,
                                          "ds2": _ds2_setup}


# ---------------------------------------------------------------------------


def _select_all(log: EpochLog, error_threshold: float
                ) -> Dict[str, SeqPointSet]:
    out = {"seqpoint": select_seqpoints(log,
                                        error_threshold=error_threshold)}
    for name, fn in ALL_BASELINES.items():
        out[name] = fn(log)
    out["kmeans"] = kmeans_seqpoints(log, k=out["seqpoint"].num_points)
    return out


def track_a(plan: BatchPlan, prov: CountedCostProvider, error_threshold: float
            ) -> dict:
    """The reference's Track A block, key for key: SeqPoints and baselines
    selected on config #1, each config's time error and speedup error, and
    the per-SL speedup and counts."""
    uniq = sorted(set(int(s) for s in plan.padded_sls))
    logs = {c: epoch_log_from_plan(plan, prov, machine=m)
            for c, m in PAPER_CONFIGS.items()}
    sel_a = _select_all(logs["config1"], error_threshold)
    actual = {c: logs[c].total_runtime for c in PAPER_CONFIGS}
    out = {"actual_seconds": actual, "methods": {}}
    for name, points in sel_a.items():
        per_cfg = {}
        for c, m in PAPER_CONFIGS.items():
            pred = project_on_config(points, prov, machine=m)
            err = abs(pred - actual[c]) / actual[c] * 100
            # speedup (throughput uplift vs config1), paper Figs. 15/16
            pred1 = project_on_config(points, prov,
                                      machine=PAPER_CONFIGS["config1"])
            sp_actual = actual["config1"] / actual[c]
            sp_pred = pred1 / pred
            per_cfg[c] = {"time_error_pct": err,
                          "speedup_actual": sp_actual,
                          "speedup_pred": sp_pred,
                          "speedup_error_pp": 100 * abs(sp_pred - sp_actual)
                          / sp_actual}
        geo = float(np.exp(np.mean([np.log(max(v["time_error_pct"], 1e-3))
                                    for v in per_cfg.values()])))
        out["methods"][name] = {"per_config": per_cfg,
                                "geomean_time_error_pct": geo,
                                "num_points": points.num_points}
    # per-SL sensitivity (Figs. 13/14): speedup of each SL, config1 -> c
    out["per_sl_speedup"] = {
        c: {int(sl): prov.profile(sl, PAPER_CONFIGS["config1"]).runtime
            / prov.profile(sl, m).runtime for sl in uniq}
        for c, m in PAPER_CONFIGS.items() if c != "config1"}
    out["per_sl_stats"] = {int(sl): dict(prov.profile(sl).stats)
                           for sl in uniq}
    return out


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    """fp32 matmuls and convolutions, TF32 off, as config1's peak assumes;
    torch leaves cuDNN's convolutions on TF32 by default. The caller's
    flags come back afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def run_reproduction(network: str, *, error_threshold: float = 0.02,
                     seed: int = 0, force: bool = False,
                     samples: Optional[int] = None, tag: str = "",
                     device="cuda",
                     model_config: Optional[Union[GNMTConfig, DS2Config]]
                     = None) -> dict:
    """Profile every unique padded SL of one synthetic epoch on both
    tracks, select SeqPoints and baselines, and project the epoch time and
    the other configs' speedups. ``model_config`` defaults to the JAX
    package's small GNMT or DS2; ``GNMTConfig()`` and ``DS2Config()`` are
    the paper's full width and depth. The steps run in fp32 with TF32
    off, whatever the caller's flags (``_no_tf32``)."""
    dev = resolve_device(device)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out_path = os.path.join(RESULTS_DIR, f"repro_torch_{network}{tag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    with _no_tf32():
        result = _reproduce(network, dev, error_threshold, seed, samples,
                            model_config)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def _reproduce(network: str, dev: torch.device, error_threshold: float,
               seed: int, samples: Optional[int],
               model_config: Optional[Union[GNMTConfig, DS2Config]]
               ) -> dict:
    setup = SETUPS[network](dev, model_config)
    if samples:
        setup["samples"] = samples
    rng = np.random.RandomState(seed)
    sls = setup["dist"].sample(rng, setup["samples"])
    plan = plan_epoch(sls, setup["batch_size"],
                      granularity=setup["granularity"],
                      sort_first=setup["sort_first"], seed=seed)
    uniq = sorted(set(int(s) for s in plan.padded_sls))
    result: dict = {
        "network": network,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "num_iterations": plan.num_batches,
        "num_unique_sls": len(uniq),
        "unique_sls": uniq,
        "sl_histogram": {int(s): int((plan.padded_sls == s).sum())
                         for s in uniq},
        "padding_waste": plan.padding_waste(),
    }

    # ---- Track W: wallclock ------------------------------------------------
    wall = WallclockProvider(setup["step_builder"], repeats=3, device=dev)
    t0 = time.perf_counter()
    log_w = epoch_log_from_plan(plan, wall)
    full_profile_seconds = time.perf_counter() - t0
    sel_w = _select_all(log_w, error_threshold)
    result["wallclock"] = {
        "total_epoch_seconds": log_w.total_runtime,
        "runtime_by_sl": {int(s): wall.cache[s].runtime for s in uniq},
        "methods": {
            name: {"num_points": s.num_points, "k": s.k,
                   "predicted": s.predicted, "actual": s.actual,
                   "error_pct": 100 * s.error,
                   "seq_lens": s.seq_lens}
            for name, s in sel_w.items()},
        "profiling": {
            "full_seconds": full_profile_seconds,
            "seqpoint_seconds": profiling_cost(
                wall, sel_w["seqpoint"].seq_lens),
            "iterations_full": plan.num_batches,
            "iterations_seqpoint": sel_w["seqpoint"].num_points,
            "iter_reduction": plan.num_batches
            / max(sel_w["seqpoint"].num_points, 1),
        },
    }

    # ---- Track A: five machine configs ------------------------------------
    prov = CountedCostProvider(setup["count_builder"],
                               PAPER_CONFIGS["config1"], device=dev)
    result["analytic"] = track_a(plan, prov, error_threshold)

    # ---- Fig. 8 analog: op histograms for nearby/far SLs -------------------
    if len(uniq) >= 4:
        picks = [uniq[0], uniq[1], uniq[len(uniq) // 2], uniq[-1]]
        result["op_histograms"] = {int(sl): prov.op_histograms[sl]
                                   for sl in picks}
    return result
