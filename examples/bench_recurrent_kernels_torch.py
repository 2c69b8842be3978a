"""Time builds of the WKV6 and selective-scan kernels on the CUDA card, in
turns, at ``chip_smoke.py``'s shapes, on its inputs and with its timers.

    python examples/bench_recurrent_kernels_torch.py [--variant NAME=SPEC]...
        [--only wkv6|mamba_scan] [--shapes NAME,...] [--rounds R]
        [--out DIR]

Each ``--variant`` names a build. SPEC is a checkout (a directory, such as
an older commit unpacked with ``git archive``), or ``MACRO=VALUE[,...]``
to build this checkout's sources with those build-time settings (the
macros the ``.cu`` files read: ``MAMBA_SCAN_CH``, ``MAMBA_SCAN_ABLATE``,
``WKV6_ABLATE``), or empty for this checkout as it
is; the default is ``this=``. An ablation build computes wrong results:
only its time is of use, its difference to the full kernel being what
the part it takes out costs in place.

Every round times every variant at every shape in turn (so a drift of the
card's clock falls on all of them alike) from CUDA graphs, as
``chip_smoke.py`` does (``time_ms_graph``, 20 calls replayed 3 times), and
eagerly. The first round also holds each variant against the plain
version at ``chip_smoke.py``'s tolerances and records whether it agrees.
Prints the card's name and power limit, a line per variant, shape and
round, and one JSON line (per variant and shape: the graph times of every
round and their median, the eager time, the error), also written to
``DIR/bench_recurrent_kernels.json``. It exits non-zero when a variant
with no ablation set disagrees with the plain version.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)

KERNELS = {
    # name: (package directory, shapes, inputs, plain version, tolerance)
    "wkv6": ("rwkv6_wkv", cs.WKV_SHAPES,
             lambda row, g: cs.wkv6_inputs(*row[1:], g), cs.wkv6_plain,
             cs.WKV_TOL),
    "mamba_scan": ("mamba_scan", cs.MAMBA_SHAPES,
                   lambda row, g: cs.mamba_inputs(*row[1:], g),
                   cs.mamba_scan_ref, cs.MAMBA_TOL),
}


def _variant_module(kernel: str, name: str, spec: str):
    """The kernel's wrapper for one variant, loaded under a name of its
    own so that every variant keeps its own library and counter."""
    pkg = KERNELS[kernel][0]
    tree = spec if os.path.isdir(spec) else ROOT
    path = os.path.join(tree, "src", "repro_torch", "kernels", pkg,
                        "kernel.py")
    loader = importlib.util.spec_from_file_location(
        f"bench_{kernel}_{name}", path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    if spec and not os.path.isdir(spec):
        # a source that sets the macros and includes the kernel's own; the
        # included file's hash makes a changed kernel build anew
        with open(mod.SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        defines = "".join(
            f"#define {d.split('=')[0]} {d.split('=')[1]}\n"
            for d in spec.split(","))
        out = os.path.join(ROOT, "build", "variants", f"{kernel}_{name}.cu")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(f"// {digest}\n{defines}#include \"{mod.SOURCE}\"\n")
        mod.SOURCE = out
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SPEC: a checkout, MACRO=VALUE[,...] or empty")
    ap.add_argument("--only", default="", choices=("", "wkv6",
                                                    "mamba_scan"))
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_recurrent_kernels_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = [v.split("=", 1) for v in args.variant or ["this="]]
    if len({spec for _, spec in variants}) < len(variants):
        sys.exit("bench_recurrent_kernels_torch: give each SPEC once")
    kernels = [args.only] if args.only else list(KERNELS)
    wanted = set(args.shapes.split(",")) if args.shapes else None
    mods = {(k, n): _variant_module(k, n, spec)
            for k in kernels for n, spec in variants}
    with ThreadPoolExecutor(len(mods)) as pool:   # one nvcc each, together
        list(pool.map(lambda m: m.build(), mods.values()))
    card = cs.card_line()
    print(card)
    res = {k: {n: {} for n, _ in variants} for k in kernels}
    bad = []
    for rnd in range(args.rounds):
        for k in kernels:
            _, shapes, inputs, plain, tol = KERNELS[k]
            g = torch.Generator(device="cuda").manual_seed(0)
            for row in shapes:
                inp = inputs(row, g)
                if wanted is not None and row[0] not in wanted:
                    continue
                want = plain(*inp) if rnd == 0 else None
                for n, spec in variants:
                    fwd = getattr(mods[(k, n)], f"{k}_fwd")
                    r = res[k][n].setdefault(row[0], {"graph_ms": []})
                    if want is not None:
                        got = fwd(*inp)
                        r["max_abs_err"] = max(
                            (a - b).abs().max().item()
                            for a, b in zip(got, want))
                        r["agrees"] = all(
                            torch.allclose(a, b, rtol=tol, atol=tol)
                            for a, b in zip(got, want))
                        if not r["agrees"] and "ABLATE" not in spec:
                            bad.append((k, n, row[0]))
                        r["eager_ms"] = cs.time_ms(lambda: fwd(*inp),
                                                   iters=20, warmup=3)
                    r["graph_ms"].append(
                        cs.time_ms_graph(lambda: fwd(*inp), iters=20))
                    print(f"{k} {n:12s} {row[0]:20s} round {rnd}: graph "
                          f"{r['graph_ms'][-1]:.5f} ms, eager "
                          f"{r['eager_ms']:.5f}, max_abs_err "
                          f"{r['max_abs_err']:.2e}"
                          f"{'' if r['agrees'] else ' (disagrees)'}")
                del inp, want
    for k in res:
        for n in res[k]:
            for r in res[k][n].values():
                r["median_ms"] = statistics.median(r["graph_ms"])
    out = {"card": card, "variants": dict(variants), "rounds": args.rounds,
           "results": res}
    print(json.dumps(out))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bench_recurrent_kernels.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    if bad:
        sys.exit(f"bench_recurrent_kernels_torch: disagrees with the plain "
                 f"version: {bad}")


if __name__ == "__main__":
    main()
