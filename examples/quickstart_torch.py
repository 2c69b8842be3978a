"""Quickstart on the PyTorch port: SeqPoint on GNMT in two minutes.

Profiles one short synthetic IWSLT-like epoch of a small GNMT — one timed
training step per unique padded SL, the LSTM recurrence running the
Hopper LSTM-cell kernel on a CUDA card — then selects SeqPoints and shows
how few iterations reproduce the epoch's total time, beside the baselines.

    python examples/quickstart_torch.py                # on the CUDA card
    python examples/quickstart_torch.py --device cpu   # plain cell on CPU

``--serve-sched`` runs the serving drill instead: a skewed-SL request stream
through the SL-aware continuous batcher (``ServeEngine.serve``) and the
run-to-completion baseline (``run_batch``) on a tiny starcoder2-3b, every
prefill's attention through the Hopper flash kernel on a card. Its grid
accounting is clock-free, so it prints the same numbers on any device
(padding waste 0.685 -> 0.384 at 83 tokens); it exits non-zero unless the
scheduler cuts padding waste by >= 25 % at equal tokens.
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


def serve_drill(device) -> bool:
    """The JAX quickstart's serving drill on the port (without its live
    Prometheus scrape, which is not ported). Returns True when the
    scheduler serves the same tokens with >= 25 % lower padding waste and
    higher grid throughput than run-to-completion."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.sched import BucketAffinePolicy, run_to_completion

    cfg = smoke_config("starcoder2-3b").with_overrides(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256)
    model = build_model(cfg, device=device, seed=0)

    def make_engine():
        return ServeEngine(model, batch_size=4, max_len=160,
                           sl_granularity=8, device=device)

    def requests(n=24, seed=0):
        # skewed SL mix: mostly short prompts, a wide straggler every 4th
        # arrival — the FIFO-batching worst case (each chunk pads to it)
        rng = np.random.RandomState(seed)
        out = []
        for i in range(n):
            sl = 128 if i % 4 == 0 else int(rng.randint(5, 17))
            out.append(Request(
                prompt=rng.randint(1, 255, size=sl).astype(np.int32),
                max_new_tokens=int(rng.randint(2, 6))))
        return out

    n = 24
    print(f"serving-load drill on {device}: {n} requests, skewed SLs "
          f"(1-in-4 at 128, rest in [5, 16])")
    obs.event("serve_drill_start", n_requests=n)
    base = run_to_completion(make_engine(), requests(n))
    sched = make_engine().serve(requests(n), policy=BucketAffinePolicy())
    for name, s in (("run-to-completion", base), ("sched", sched)):
        print(f"  {name:18s} waste={s.padding_waste:.3f} "
              f"grid_tput={s.grid_throughput:.4f} tokens={s.tokens_out} "
              f"prefills={s.prefills} decode_steps={s.decode_steps}")
    red = 1.0 - sched.padding_waste / base.padding_waste \
        if base.padding_waste else 0.0
    print(f"  padding-waste reduction: {100 * red:.1f}% "
          f"(acceptance bar: 25%)")
    ok = (sched.tokens_out == base.tokens_out
          and sched.padding_waste <= 0.75 * base.padding_waste
          and sched.grid_throughput > base.grid_throughput)
    obs.event("serve_drill_end", ok=bool(ok), waste_base=base.padding_waste,
              waste_sched=sched.padding_waste, reduction=red,
              tokens=sched.tokens_out)
    print(f"  serving drill: {'OK' if ok else 'FAILED'}")
    return ok


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--obs-dir", default=None,
                    help="enable tracing/metrics/events, export here")
    ap.add_argument("--serve-sched", action="store_true",
                    help="run only the serving drill: SL-aware continuous "
                         "batching vs run-to-completion")
    args = ap.parse_args()
    if args.obs_dir:
        obs.enable(out_dir=args.obs_dir)
    device = resolve_device(args.device)
    if args.serve_sched:
        ok = serve_drill(device)
        if args.obs_dir:
            obs.export_all()
        sys.exit(0 if ok else 1)

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
