"""Host cost of one LSTM-cell call on the card by each way of calling the
kernel: the ctypes launch itself (``kernel.lstm_cell_fwd``), the
``torch.library`` op the port calls (``torch.ops.repro_torch.lstm_cell_fwd``,
its CUDA implementation that same launch, here with its (h, c) outputs
allocated as the port's forward allocates them), the port's whole forward
(``ops._cell_fwd``) and, for comparison, the same launch registered with
``torch.library.custom_op`` (defined here only).

    python3 examples/bench_op_dispatch_torch.py [--calls 4000] [--rounds 5]

Card only. Each round times ``--calls`` calls of each way in turn on the
same inputs, the wall time of the Python loop with one synchronize at its
end, so a way whose host time exceeds the kernel's device time shows its
host time per call. Two shapes: GNMT's main cell (16, 2048, 1024), where
the device time is ~16 us, and a tiny cell (1, 64, 64), whose device time
is a few microseconds. Prints the card's name and power limit and one JSON
line: the median over rounds of the microseconds per call, by shape and
way.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPES = {"gnmt (16, 2048, 1024)": (16, 2048, 1024),
          "tiny (1, 64, 64)": (1, 64, 64)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=4000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_op_dispatch_torch: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.device import card_line
    from repro_torch.kernels.lstm_cell import kernel, ops

    @torch.library.custom_op("bench_op_dispatch::lstm_cell_fwd",
                             mutates_args=())
    def custom(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return kernel.lstm_cell_fwd(xh, w, b, c)

    op = torch.ops.repro_torch.lstm_cell_fwd.default

    def library(xh, w, b, c):
        h_out, c_out = torch.empty_like(c), torch.empty_like(c)
        op(xh, w, b, c, h_out, c_out, None)
        return h_out, c_out

    ways = {"ctypes launch": kernel.lstm_cell_fwd,
            "library op": library,
            "port forward (ops._cell_fwd)": ops._cell_fwd,
            "custom_op": custom}
    print(card_line())
    kernel.build()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, (bsz, k, h) in SHAPES.items():
        xh = torch.randn(bsz, k, device="cuda", generator=g)
        w = torch.randn(k, h, 4, device="cuda", generator=g) * 0.02
        b = torch.zeros(h, 4, device="cuda")
        c = torch.randn(bsz, h, device="cuda", generator=g)
        times = {name: [] for name in ways}
        for name, fn in ways.items():           # warm-up, checks agreement
            hn, cn = fn(xh, w, b, c)
            ref = kernel.lstm_cell_fwd(xh, w, b, c)
            if not (torch.equal(hn, ref[0]) and torch.equal(cn, ref[1])):
                raise RuntimeError(f"{name} disagrees with the launch")
        for _ in range(args.rounds):
            for name, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    fn(xh, w, b, c)
                torch.cuda.synchronize()
                times[name].append(
                    (time.perf_counter() - t0) / args.calls * 1e6)
        out[label] = {name: float(np.median(v)) for name, v in times.items()}
        print(f"{label}: " + ", ".join(f"{n} {v:.2f} us"
                                       for n, v in out[label].items()))
    print(json.dumps({"us_per_call": out, "calls": args.calls,
                      "rounds": args.rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
