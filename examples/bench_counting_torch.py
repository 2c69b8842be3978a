"""What Track A's counting pass costs, with and without a nested
``FlopCounterMode``.

``count_costs`` counts FLOPs, bytes and the op histogram in one dispatch
mode that reads ``FlopCounterMode``'s formulas itself. The other design
nests ``FlopCounterMode`` for the FLOPs and keeps only the bytes and the
histogram in the port's mode. This script runs ``run_reproduction``'s
counting step (GNMT's plain cell, DS2's step) under both, once each to
warm up, then alternating ``own, nested, nested, own, ...``, and prints
the seconds of each pass, the ops dispatched and the host time per op,
and checks that both give the same FLOPs.

    python examples/bench_counting_torch.py [--network gnmt|ds2] [--sl N]
        [--full] [--device cpu|cuda] [--pairs 2] [--out DIR]

``--full`` builds ``GNMTConfig()`` / ``DS2Config()``; the default is the
JAX package's small GNMT / DS2. Prints a JSON summary and writes it to
``DIR/bench_counting_<net>_sl<N>.json``.
"""
import argparse
import json
import os
import statistics
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import characterize
from repro_torch.core.reproduction import SETUPS
from repro_torch.device import card_line, resolve_device
from repro_torch.models.rnn import DS2Config, GNMTConfig


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def own(fn, args):
    """The port's counter: one mode, FLOPs from the registry it reads."""
    flops, _, hist = characterize.count_costs(fn, *args)
    return flops, sum(hist.values())


def nested(fn, args):
    """``FlopCounterMode`` counts the FLOPs; the port's mode, its registry
    emptied, counts only bytes and the histogram."""
    with mock.patch.object(characterize, "flop_registry", {}), \
            FlopCounterMode(display=False) as fc:
        _, _, hist = characterize.count_costs(fn, *args)
    return float(fc.get_total_flops()), sum(hist.values())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", choices=("gnmt", "ds2"), default="gnmt")
    ap.add_argument("--sl", type=int, default=None,
                    help="padded SL (default 64 for gnmt, 704 for ds2)")
    ap.add_argument("--full", action="store_true",
                    help="the paper's GNMTConfig() / DS2Config()")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    sl = args.sl or (64 if args.network == "gnmt" else 704)
    cfg = None
    if args.full:
        cfg = GNMTConfig() if args.network == "gnmt" else DS2Config()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, fargs = SETUPS[args.network](dev, cfg)["count_builder"](sl)

    for warm in (own, nested):          # first passes warm both counters
        warm(fn, fargs)
    _sync(dev)
    times = {"own": [], "nested": []}
    counts = {}
    for name in ("own", "nested", "nested", "own") * args.pairs:
        t0 = time.perf_counter()
        counts[name] = (own if name == "own" else nested)(fn, fargs)
        _sync(dev)
        times[name].append(time.perf_counter() - t0)
    (f_own, ops), (f_nested, ops_nested) = counts["own"], counts["nested"]
    if f_own != f_nested or ops != ops_nested:
        sys.exit(f"bench_counting_torch: the counters disagree: "
                 f"{counts}")
    med = {k: statistics.median(v) for k, v in times.items()}
    summary = {
        "card": card_line() if dev.type == "cuda" else None,
        "device": str(dev), "network": args.network, "sl": sl,
        "config": "full" if args.full else "small",
        "flops": f_own, "ops": ops,
        "seconds": times,
        "median_s": med,
        "us_per_op": {k: v / ops * 1e6 for k, v in med.items()},
        "nested_over_own": med["nested"] / med["own"],
    }
    print(json.dumps(summary, indent=1))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_counting_{args.network}_sl{sl}"
                           ".json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
