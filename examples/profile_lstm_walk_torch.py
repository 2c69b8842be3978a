"""Where a step of the LSTM's backward walk goes, on the CUDA card.

Builds ``csrc/lstm_seq_bwd.cu`` with ``LSTM_BWD_PROFILE`` set (each block's
thread 0 counts its cycles by phase: gate math, grid barrier, product, the
warps' sum) beside the plain build, runs both at ``chip_smoke.py``'s
``SEQ_BWD_SHAPES`` on its ``walk_inputs``, and prints each build's time
from CUDA graphs and, for the profiled one, the cycles a step by phase
(mean, least and most over the blocks) and the clock they imply.

    python3 examples/profile_lstm_walk_torch.py [--out DIR]

Writes the numbers to ``DIR/profile_lstm_walk.json`` as well.
"""
import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lstm_cell import kernel  # noqa: E402

PHASES = ("gate", "barrier", "product", "sum")


def load(defines: dict) -> ctypes.CDLL:
    lib = _build.load("lstm_seq_bwd", (kernel.SOURCE_BWD,), defines)
    lib.lstm_seq_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.lstm_seq_bwd.restype = ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_lstm_walk_torch: no CUDA device")
    card = cs.card_line()
    print(card)
    libs = {"plain": load({}), "profile": load({"LSTM_BWD_PROFILE": 1})}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "shapes": {}}
    for name, b, s, d, h in cs.SEQ_BWD_SHAPES:
        zs, c, w, gy = cs.walk_inputs(b, s, d, h, g)
        row = {}
        for build, lib in libs.items():
            kernel.build_bwd = lambda lib=lib: lib
            ms = cs.time_ms_graph(lambda: kernel.lstm_seq_bwd(zs, c, w, gy),
                                  iters=20)
            row[f"{build}_ms"] = ms
        torch.cuda.synchronize()
        cycles = np.zeros((1024, 4), dtype=np.uint64)
        err = libs["profile"].lstm_seq_bwd_profile(
            ctypes.c_void_p(cycles.ctypes.data))
        if err:
            sys.exit(f"profile_lstm_walk_torch: CUDA error {err}")
        blocks = -(-h // kernel.walk_units(h, sms))
        per = cycles[:blocks].astype(np.float64) / s
        row["cycles_a_step"] = {
            p: {"mean": per[:, i].mean(), "min": per[:, i].min(),
                "max": per[:, i].max()} for i, p in enumerate(PHASES)}
        total = per.sum(1).mean()
        row["total_cycles_a_step"] = total
        row["clock_ghz"] = total * s / (row["profile_ms"] * 1e-3) / 1e9
        print(f"{name} B={b} S={s} H={h}: {row['plain_ms']:.4f} ms "
              f"(profiled build {row['profile_ms']:.4f}); cycles a step, mean "
              f"over {blocks} blocks: " + ", ".join(
                  f"{p} {row['cycles_a_step'][p]['mean']:.0f}"
                  for p in PHASES)
              + f"; total {total:.0f} at {row['clock_ghz']:.3f} GHz")
        out["shapes"][name] = row
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_lstm_walk.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
