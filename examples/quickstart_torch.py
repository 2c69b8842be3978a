"""Quickstart on the PyTorch port: SeqPoint on GNMT in two minutes.

Profiles one short synthetic IWSLT-like epoch of a small GNMT — one timed
training step per unique padded SL, the LSTM recurrence running the
Hopper LSTM-cell kernel on a CUDA card — then selects SeqPoints and shows
how few iterations reproduce the epoch's total time, beside the baselines.

    python examples/quickstart_torch.py                # on the CUDA card
    python examples/quickstart_torch.py --device cpu   # plain cell on CPU
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import obs
from repro_torch.core import (
    frequent,
    median,
    prior,
    select_seqpoints,
    worst,
)
from repro_torch.core.characterize import WallclockProvider, epoch_log_from_plan
from repro_torch.core.reproduction import SETUPS
from repro_torch.data.batching import plan_epoch
from repro_torch.device import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--obs-dir", default=None,
                    help="enable tracing/metrics/events, export here")
    args = ap.parse_args()
    if args.obs_dir:
        obs.enable(out_dir=args.obs_dir)
    device = resolve_device(args.device)

    setup = SETUPS["gnmt"](device)
    rng = np.random.RandomState(0)
    sls = setup["dist"].sample(rng, 1280)
    plan = plan_epoch(sls, setup["batch_size"],
                      granularity=setup["granularity"])
    print(f"epoch: {plan.num_batches} iterations, "
          f"{len(set(map(int, plan.padded_sls)))} unique padded SLs, "
          f"on {device}")
    obs.event("run_start", example="quickstart_torch", network="gnmt",
              iterations=plan.num_batches)

    print("profiling every unique SL (the expensive ground-truth pass)...")
    provider = WallclockProvider(setup["step_builder"], repeats=3,
                                 device=device)
    with obs.span("quickstart/profile_epoch"):
        log = epoch_log_from_plan(plan, provider)
    print(f"measured epoch time: {log.total_runtime:.2f}s")

    with obs.span("quickstart/select_seqpoints"):
        sp = select_seqpoints(log, error_threshold=0.02)
    print(f"\nSeqPoints: {sp.num_points} iterations (k={sp.k}) "
          f"-> projected {sp.predicted:.2f}s, error {100*sp.error:.2f}%")
    print(f"  SLs: {sp.seq_lens}")
    obs.event("seqpoints_selected", num_points=sp.num_points, k=sp.k,
              error=sp.error, converged=sp.meta.get("converged"))
    for name, fn in (("frequent", frequent), ("median", median),
                     ("worst", worst), ("prior", prior)):
        b = fn(log)
        print(f"  {name:9s}: {b.num_points:3d} iterations, "
              f"error {100*b.error:6.2f}%")
    red = plan.num_batches / sp.num_points
    print(f"\nprofiling reduction: {red:.0f}x fewer iterations "
          f"(paper reports 214x/345x at full dataset scale)")
    if args.obs_dir:
        for kind, path in sorted(obs.export_all().items()):
            print(f"  {kind:13s} {path}")


if __name__ == "__main__":
    main()
