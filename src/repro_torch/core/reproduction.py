"""End-to-end SeqPoint reproduction on GNMT, wallclock track, in PyTorch.

Track W of ``repro.core.reproduction``: really run GNMT training iterations
per unique padded SL on the device; SeqPoint and every baseline project the
epoch's total training time (paper Figs. 11/12). Per-SL profiling cost
(warmup + measure seconds) is recorded too — the quantity SeqPoint reduces
(paper §VI-F). The analytic machine-config track, the Fig. 8 op histogram
and DS2 have not been ported yet.

Results cache to results/repro_torch_<network><tag>.json, in the JAX
package's schema without its ``analytic`` and ``op_histograms`` keys.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.baselines import ALL_BASELINES
from repro_torch.core.characterize import (
    WallclockProvider,
    epoch_log_from_plan,
    profiling_cost,
)
from repro_torch.core.clustering import kmeans_seqpoints
from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPointSet, select_seqpoints
from repro_torch.data.batching import plan_epoch
from repro_torch.data.synthetic import IWSLT_LIKE
from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.models.rnn import GNMT, GNMTConfig

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results")

# the JAX package's reduced GNMT for its wallclock track
SMALL_GNMT = GNMTConfig(vocab_size=2048, d_model=96, num_enc_uni=2,
                        num_dec=2)


# ---------------------------------------------------------------------------
# network setups


def _gnmt_setup(device: torch.device,
                model_config: Optional[GNMTConfig] = None) -> dict:
    model = GNMT(model_config or SMALL_GNMT, seed=0, device=device)
    params = list(model.parameters())
    if device.type == "cuda":
        lstm_kernel.build()       # nvcc before profiling, not in its cost

    def step_builder(sl: int):
        batch = model.make_batch(sl, 16, sl, sl)

        def step(b):
            # the update is computed and dropped, as the JAX step returns
            # new params that are never fed back: every repeat starts from
            # the same parameters
            loss, _ = model.loss(b)
            grads = torch.autograd.grad(loss, params)
            return loss, [p.detach() - 1e-4 * g for p, g in zip(params, grads)]

        return step, (batch,)

    return dict(step_builder=step_builder, dist=IWSLT_LIKE, batch_size=64,
                granularity=4, sort_first=False, samples=6400)


SETUPS: Dict[str, Callable[..., dict]] = {"gnmt": _gnmt_setup}


# ---------------------------------------------------------------------------


def _select_all(log: EpochLog, error_threshold: float
                ) -> Dict[str, SeqPointSet]:
    out = {"seqpoint": select_seqpoints(log,
                                        error_threshold=error_threshold)}
    for name, fn in ALL_BASELINES.items():
        out[name] = fn(log)
    out["kmeans"] = kmeans_seqpoints(log, k=out["seqpoint"].num_points)
    return out


def run_reproduction(network: str, *, error_threshold: float = 0.02,
                     seed: int = 0, force: bool = False,
                     samples: Optional[int] = None, tag: str = "",
                     device="cuda",
                     model_config: Optional[GNMTConfig] = None) -> dict:
    """Profile every unique padded SL of one synthetic epoch, select
    SeqPoints and baselines, and project the epoch time. ``model_config``
    defaults to the JAX package's small GNMT; ``GNMTConfig()`` is the
    paper's full width and depth."""
    dev = resolve_device(device)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out_path = os.path.join(RESULTS_DIR, f"repro_torch_{network}{tag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

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

    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    return result
