"""Perf hillclimb runner, a port of ``repro.launch.perf``: re-derive a
cell's roofline terms under an optimization and record baseline vs
optimized (``results/perf_torch_<tag>.json``).

    python -m repro_torch.launch.perf --cell deepseek-v3-671b/train_4k \\
        --opt moe_full_ep --hypothesis "..." [--device cpu]

Both runs trace the cell's step on fake tensors on the single-pod mesh
(``launch.dryrun``'s roofline mode), on the card's path unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

import torch

from repro_torch.configs import SINGLE_POD
from repro_torch.launch.dryrun import RESULTS_DIR, fake_process_group, run_cell
from repro_torch.launch.mesh import make_mesh

OPTS: Dict[str, Dict[str, Any]] = {
    "moe_full_ep": {"moe_full_ep": True},
    "dp_only": {"parallelism": "dp_only"},
    "moe_full_ep_serve": {"moe_full_ep": True, "fsdp": False},
    "no_fsdp": {"fsdp": False},
    "nmicro4": {"microbatches": 4},
    "save_boundaries": {"remat": "save_boundaries"},
    "moe_full_ep_zero1": {"moe_full_ep": True, "zero_stage": 1},
}


def terms_of(rec: dict) -> dict:
    t = rec["terms"]
    bound = max(t.values())
    return {"compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"], "bound_s": bound,
            "dominant": rec["dominant"],
            "fraction": rec["roofline_fraction"],
            "useful_flops_ratio": rec["useful_flops_ratio"],
            "collectives": rec["collectives"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)         # arch/shape
    ap.add_argument("--opt", required=True, choices=sorted(OPTS))
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    arch, shape_name = args.cell.split("/")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("perf: --device cuda needs a CUDA card; pass "
                         "--device cpu to trace the plain path")

    with fake_process_group(SINGLE_POD.num_devices):
        mesh = make_mesh(SINGLE_POD, device.type)
        base = run_cell(arch, shape_name, SINGLE_POD, mesh, "roofline",
                        device)
        if base["status"] != "ok":
            print("baseline failed:", base.get("error"), file=sys.stderr)
            return 1
        opt = run_cell(arch, shape_name, SINGLE_POD, mesh, "roofline",
                       device, **OPTS[args.opt])
    if opt["status"] != "ok":
        print("optimized failed:", opt.get("error"), file=sys.stderr)
        print(opt.get("traceback", ""), file=sys.stderr)
        return 1

    b, o = terms_of(base), terms_of(opt)
    out = {
        "cell": f"{arch}-{shape_name}-{args.opt}",
        "arch": arch, "shape": shape_name, "opt": args.opt,
        "hypothesis": args.hypothesis,
        "baseline": b, "optimized": o,
        "speedup": b["bound_s"] / max(o["bound_s"], 1e-12),
        "confirmed": o["bound_s"] < b["bound_s"],
    }
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = args.tag or f"{arch}_{shape_name}_{args.opt}"
    path = os.path.join(RESULTS_DIR, f"perf_torch_{tag}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("baseline", "optimized")}, indent=1))
    print("baseline :", json.dumps({k: round(v, 4) if isinstance(v, float)
                                    else v for k, v in b.items()
                                    if k != "collectives"}))
    print("optimized:", json.dumps({k: round(v, 4) if isinstance(v, float)
                                    else v for k, v in o.items()
                                    if k != "collectives"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
