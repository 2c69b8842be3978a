"""Time builds of the WKV6 and selective-scan kernels, and of the
flash-attention and LSTM-cell backwards, on the CUDA card, in turns, at
``chip_smoke.py``'s shapes, on its inputs and with its timers.

    python examples/bench_recurrent_kernels_torch.py [--variant NAME=SPEC]...
        [--only wkv6|mamba_scan|wkv6_bwd|mamba_scan_bwd|flash_attention_bwd
                |lstm_cell_bwd]
        [--shapes NAME,...] [--rounds R] [--profile] [--out DIR]

The forward kernels run at ``chip_smoke.py``'s ``WKV_SHAPES`` and
``MAMBA_SHAPES``, the backward kernels (``wkv6_bwd``, ``mamba_scan_bwd``)
at its ``WKV_BWD_SHAPES`` and ``MAMBA_BWD_SHAPES`` with a random output
cotangent, as its phases 8b and 11b call them; ``flash_attention_bwd`` at
its ``FLASH_BWD_SHAPES`` on this checkout's forward's o and lse, as phase
5b calls it; ``lstm_cell_bwd`` at its ``CELL_SHAPES`` on the plain
forward's z and random cotangents, as phase 2b calls it.

Each ``--variant`` names a build. SPEC is a checkout (a directory, such as
an older commit unpacked with ``git archive``), or ``NAME=VALUE[,...]``
to build this checkout's sources with those settings, or empty for this
checkout as it is; the default is ``this=``. A NAME that the kernel's
wrapper defines sets that attribute of it (``BWD_THREADS_PER_CHANNEL``,
the scan backward's threads a channel, with which it builds its kernel);
any other is a macro the ``.cu`` files read (``MAMBA_SCAN_CH``,
``MAMBA_SCAN_ABLATE``, ``WKV6_ABLATE``, ``FLASH_BWD_ABLATE``,
``LSTM_BWD_ABLATE``). An ablation
build computes wrong results: only its time is of use, its difference to
the full kernel being what the part it takes out costs in place.

Every round times every variant at every shape in turn, odd rounds in
reverse order (so a drift of the card's clock falls on all of them
alike), from CUDA graphs, as ``chip_smoke.py`` does (``time_ms_graph``,
20 calls replayed 3 times), and eagerly. The first round also holds each
variant against the plain version at ``chip_smoke.py``'s tolerances (a
backward kernel's every gradient against the plain VJP's, within
``BWD_TOL`` or ``BWD_TOL_BF16`` of its max, the flash backward's bf16
gradients within ``FLASH_BWD_TOL_BF16``, the LSTM backward's dz, dxh and
dc_prev within ``TOL``) and records whether it agrees.

Prints the card's name and power limit, a line per variant, shape and
round, and one JSON line (per variant and shape: the graph times of every
round and their median, the eager time, the error; for the flash backward
also SDPA's backward on the same inputs, timed once a shape as
``chip_smoke.py``'s ``sdpa_bwd_ms`` times it: the yardstick, never a
variant), also written to ``DIR/bench_recurrent_kernels.json``. With
``--profile`` the first round also traces five calls of each variant with
``torch.profiler`` and records the device time of each of its kernels per
call (``kernels_ms``). It exits non-zero when a variant with no ablation
set disagrees with the plain version.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)



class Kernel(NamedTuple):
    pkg: str            # package directory under repro_torch/kernels
    shapes: list        # chip_smoke.py's rows
    inputs: Callable    # (row, generator) -> the call's arguments
    plain: Callable     # the plain version (or VJP)
    tol: float
    source: str         # the wrapper's attribute naming its .cu file
    build: str          # the wrapper's build function
    call: str           # the wrapper's launch
    compare: Callable   # (got, want, tol) -> (max abs error, agrees)
    library: Optional[Callable] = None   # (*inputs) -> (ms, note): the
    # PyTorch call for the same function, timed once a shape (yardstick)


def _agrees(got, want, tol):
    """(max abs error, agrees) of a forward's outputs at ``tol``."""
    return (max((a - b).abs().max().item() for a, b in zip(got, want)),
            all(torch.allclose(a, b, rtol=tol, atol=tol)
                for a, b in zip(got, want)))


def _grads_agree(got, want, _tol):
    """(max abs error, agrees) of a backward's gradients against the plain
    VJP's, each within its tolerance of its max (``cs.grad_gaps``)."""
    gaps = cs.grad_gaps(got[:len(want)], want)
    return (max(gp[0] for gp in gaps), all(gp[1] <= gp[2] for gp in gaps))


def _flash_grads_agree(got, want, _tol):
    """``_grads_agree`` at the flash backward's tolerance for bf16."""
    gaps = [(e, r, cs.FLASH_BWD_TOL_BF16 if w.dtype == torch.bfloat16
             else t)
            for (e, r, t), w in zip(cs.grad_gaps(got[:len(want)], want),
                                    want)]
    return (max(gp[0] for gp in gaps), all(gp[1] <= gp[2] for gp in gaps))


def _flash_bwd_inputs(row, g):
    """A phase-5b row's call: q, k, v cut from a projection, this
    checkout's forward's o and lse, a random cotangent, causal."""
    _, b, hq, hkv, sq, skv, dh, causal, dt = row
    q, k, v = cs.flash_inputs(b, hq, hkv, sq, skv, dh, dt, g)
    o, lse = cs.flash.flash_attention_fwd(q, k, v, causal)
    gy = torch.randn((b, sq, hq, dh), device="cuda", generator=g).to(dt)
    return q, k, v, o, lse, gy, causal


def _with_gy(args, shape, g):
    """A backward call's arguments: the forward's and a random cotangent
    of y."""
    return (*args, torch.randn(shape, device="cuda", generator=g))


KERNELS = {
    "wkv6": Kernel(
        "rwkv6_wkv", cs.WKV_SHAPES,
        lambda row, g: cs.wkv6_inputs(*row[1:], g), cs.wkv6_plain,
        cs.WKV_TOL, "SOURCE", "build", "wkv6_fwd", _agrees),
    "mamba_scan": Kernel(
        "mamba_scan", cs.MAMBA_SHAPES,
        lambda row, g: cs.mamba_inputs(*row[1:], g), cs.mamba_scan_ref,
        cs.MAMBA_TOL, "SOURCE", "build", "mamba_scan_fwd", _agrees),
    "wkv6_bwd": Kernel(
        "rwkv6_wkv", cs.WKV_BWD_SHAPES,
        lambda row, g: _with_gy(cs.wkv6_inputs(*row[1:], False, g),
                                row[1:], g),
        cs.wkv6_bwd_plain, cs.BWD_TOL, "SOURCE_BWD", "build_bwd",
        "wkv6_bwd", _grads_agree),
    "mamba_scan_bwd": Kernel(
        "mamba_scan", cs.MAMBA_BWD_SHAPES,
        lambda row, g: _with_gy(cs.mamba_inputs(*row[1:], False, g),
                                row[1:4], g),
        cs.mamba_scan_bwd_plain, cs.BWD_TOL, "SOURCE_BWD", "build_bwd",
        "mamba_scan_bwd", _grads_agree),
    "flash_attention_bwd": Kernel(
        "flash_attention", cs.FLASH_BWD_SHAPES, _flash_bwd_inputs,
        lambda q, k, v, o, lse, gy, causal:
            cs.flash_ops.flash_bwd_plain(q, k, v, gy, causal),
        cs.BWD_TOL, "SOURCE_BWD", "build_bwd", "flash_attention_bwd",
        _flash_grads_agree,
        lambda q, k, v, o, lse, gy, causal: cs.sdpa_bwd_ms(q, k, v, gy,
                                                           causal)),
    "lstm_cell_bwd": Kernel(
        "lstm_cell", cs.CELL_SHAPES,
        lambda row, g: cs.lstm_bwd_inputs(*row[1:], g)[:5],
        cs.lstm_cell_bwd_plain, cs.TOL, "SOURCE_BWD", "build_bwd",
        "lstm_cell_bwd", _agrees),
}


def _kernels_ms(fn, calls: int = 5) -> dict:
    """Device time per call of each kernel ``fn`` launches, by kernel
    function name, from a ``torch.profiler`` trace of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        # "void (anonymous namespace)::name<...>(...)" -> name
        found = re.findall(r"(\w+)(?:<[^()]*>)?\(", e.key)
        name = found[0] if found else e.key
        out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def _variant_module(kernel: str, name: str, spec: str):
    """The kernel's wrapper for one variant, loaded under a name of its
    own so that every variant keeps its own library and counter."""
    pkg = KERNELS[kernel].pkg
    tree = spec if os.path.isdir(spec) else ROOT
    path = os.path.join(tree, "src", "repro_torch", "kernels", pkg,
                        "kernel.py")
    loader = importlib.util.spec_from_file_location(
        f"bench_{kernel}_{name}", path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    if not spec or os.path.isdir(spec):
        return mod
    macros = {}
    for key, value in (d.split("=") for d in spec.split(",")):
        if hasattr(mod, key):
            setattr(mod, key, int(value))
        else:
            macros[key] = value
    if macros:
        # a source that sets the macros and includes the kernel's own; the
        # included file's hash makes a changed kernel build anew
        attr = KERNELS[kernel].source
        src = getattr(mod, attr)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        defines = "".join(f"#define {k} {v}\n" for k, v in macros.items())
        out = os.path.join(ROOT, "build", "variants", f"{kernel}_{name}.cu")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(f"// {digest}\n{defines}#include \"{src}\"\n")
        setattr(mod, attr, out)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SPEC: a checkout, NAME=VALUE[,...] or empty")
    ap.add_argument("--only", default="", choices=("", *KERNELS))
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="trace each variant's kernels in the first round")
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
        list(pool.map(lambda km: getattr(km[1], KERNELS[km[0][0]].build)(),
                      mods.items()))
    card = cs.card_line()
    print(card)
    res = {k: {n: {} for n, _ in variants} for k in kernels}
    libs = {}
    bad = []
    for rnd in range(args.rounds):
        for k in kernels:
            kern = KERNELS[k]
            g = torch.Generator(device="cuda").manual_seed(0)
            for row in kern.shapes:
                inp = kern.inputs(row, g)
                if wanted is not None and row[0] not in wanted:
                    continue
                want = kern.plain(*inp) if rnd == 0 else None
                if rnd == 0 and kern.library is not None:
                    lib_ms, note = kern.library(*inp)
                    libs.setdefault(k, {})[row[0]] = {"ms": lib_ms,
                                                      "note": note}
                    print(f"{k} library {row[0]:20s}: "
                          + (f"{lib_ms:.5f} ms" if lib_ms is not None
                             else f"not run ({note})"))
                # odd rounds take the variants in reverse: A B, B A, ...
                for n, spec in variants[::1 if rnd % 2 == 0 else -1]:
                    fwd = getattr(mods[(k, n)], kern.call)
                    r = res[k][n].setdefault(row[0], {"graph_ms": []})
                    if want is not None:
                        got = fwd(*inp)
                        r["max_abs_err"], r["agrees"] = kern.compare(
                            got, want, kern.tol)
                        del got
                        if not r["agrees"] and "ABLATE" not in spec:
                            bad.append((k, n, row[0]))
                        r["eager_ms"] = cs.time_ms(lambda: fwd(*inp),
                                                   iters=20, warmup=3)
                        if args.profile:
                            r["kernels_ms"] = _kernels_ms(lambda: fwd(*inp))
                            print(f"{k} {n} {row[0]} kernels (ms a call): "
                                  + ", ".join(f"{kn} {v:.5f}" for kn, v in
                                              r["kernels_ms"].items()))
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
           "results": res, "library": libs}
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
