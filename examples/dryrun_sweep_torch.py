"""The whole dry-run sweep of the port, one process per cell.

    python3 examples/dryrun_sweep_torch.py [--jobs 8] [--device cuda]
        [--out-dir results] [--modes compile,roofline] [--archs all]
        [--meshes single,multi] [--shapes all] [--cell-timeout 3000]

Runs ``python -m repro_torch.launch.dryrun --arch A --shape S --mode M
--mesh X`` for every cell of the registry's archs, compile mode on both
meshes (64 cells) and roofline mode on the single pod (32 cells),
``--jobs`` processes at a time (each traces on one CPU core; the longest,
the recurrent archs' train cells, start first; a cell still running after
``--cell-timeout`` seconds is stopped and recorded as an error), then
merges the records into
``dryrun_torch_compile_both.jsonl`` and ``dryrun_torch_roofline_single
.jsonl`` under ``--out-dir`` with the projection report of each, and prints
one summary line per mode: cells ok, seconds per cell, and the worst and
median ``live_bytes_per_device`` against the card's 80 GiB. A cell's
seconds are its own process's wall time beside ``--jobs`` - 1 others.
Exits non-zero when a cell failed (its error is in its record).
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import (  # noqa: E402
    get_model_config,
    list_archs,
    shapes_for,
)
from repro_torch.obs.projection import (  # noqa: E402
    collective_projection_report,
)

# the train cells of these archs run the WKV6 / scan VJP loops: start first
SLOW = ("jamba-v0.1-52b", "rwkv6-3b")


def _job(args, arch, shape, mode, mesh) -> dict:
    out = os.path.join(args.out_dir, "cells",
                       f"dryrun_torch_{mode}_{mesh}_{arch}_{shape}.jsonl")
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mode", mode, "--mesh", mesh,
           "--device", args.device, "--out", out]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              env=env, timeout=args.cell_timeout)
        rc, err = proc.returncode, proc.stderr[-3000:]
    except subprocess.TimeoutExpired:
        rc, err = None, ""
    recs = []
    if os.path.exists(out):
        with open(out) as f:
            recs = [json.loads(line) for line in f]
    if not recs:
        mesh_name = "16x16" if mesh == "single" else "2x16x16"
        recs = [{"arch": arch, "shape": shape, "mesh": mesh_name,
                 "mode": mode, "status": "error",
                 "error": (f"stopped after {args.cell_timeout} s"
                           if rc is None else f"exit {rc}: {err[-500:]}"),
                 "seconds": time.perf_counter() - t0}]
    return {"arch": arch, "shape": shape, "mode": mode, "mesh": mesh,
            "rc": rc, "records": recs}


def _summary(mode: str, recs: list) -> dict:
    ok = [r for r in recs if r["status"] == "ok"]
    out = {"mode": mode, "cells": len(recs), "ok": len(ok),
           "failed": [f"{r['arch']}/{r['shape']}@{r['mesh']}: "
                      f"{r.get('error', '')[:300]}"
                      for r in recs if r["status"] != "ok"],
           "seconds": {f"{r['arch']}/{r['shape']}@{r['mesh']}": r["seconds"]
                       for r in recs}}
    live = sorted((r["memory"]["live_bytes_per_device"],
                   f"{r['arch']}/{r['shape']}@{r['mesh']}")
                  for r in ok if "memory" in r)
    if live:
        out["live_worst"] = {"cell": live[-1][1], "bytes": live[-1][0]}
        out["live_median_bytes"] = live[len(live) // 2][0]
        out["over_80gib"] = [c for b, c in live if b >= 80 * 2**30]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "results"))
    ap.add_argument("--modes", default="compile,roofline")
    ap.add_argument("--archs", default="all")
    ap.add_argument("--meshes", default="single,multi",
                    help="compile mode's meshes (roofline: single)")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--cell-timeout", type=float, default=3000)
    args = ap.parse_args()
    archs = list_archs() if args.archs == "all" else args.archs.split(",")
    os.makedirs(os.path.join(args.out_dir, "cells"), exist_ok=True)

    jobs = []
    for mode in args.modes.split(","):
        meshes = args.meshes.split(",") if mode == "compile" \
            else ("single",)
        for mesh in meshes:
            for arch in archs:
                for shape in shapes_for(get_model_config(arch)):
                    if args.shapes in ("all", shape.name):
                        jobs.append((arch, shape.name, mode, mesh))
    jobs.sort(key=lambda j: (not (j[0] in SLOW and j[1] == "train_4k"),
                             j[2] != "compile"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda j: _job(args, *j), jobs))
    wall = time.perf_counter() - t0

    n_fail = 0
    for mode in args.modes.split(","):
        mesh = "both" if mode == "compile" else "single"
        recs = [r for d in done if d["mode"] == mode for r in d["records"]]
        path = os.path.join(args.out_dir, f"dryrun_torch_{mode}_{mesh}.jsonl")
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        with open(path[:-len(".jsonl")] + "_projection.json", "w") as f:
            json.dump(collective_projection_report(recs), f, indent=1)
        summary = _summary(mode, recs)
        summary["wall_s"] = wall
        print(f"sweep {mode} " + json.dumps(summary))
        n_fail += summary["cells"] - summary["ok"]
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
