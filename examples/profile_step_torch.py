"""Where the time of one GNMT or DS2 training step goes, on the CUDA card.

Builds the port's GNMT (``GNMTConfig()``, batch 16) or DS2 (``DS2Config()``,
batch 8) at the paper's full width and depth and runs the step
``run_reproduction`` times — loss, gradients, and the dropped update — at
one padded SL:

1. untraced: forward and backward wall time, each ended by a synchronize,
   over three repeats (medians), and the host's time to enqueue the
   forward (before its synchronize): a forward that is mostly enqueue
   waits on the host, not on the card;
2. traced with ``torch.profiler``: device time summed by kernel name, the
   LSTM kernels' launches (GNMT: the cell's and its backward's), and
   device busy time over the untraced step's wall time (its complement is
   the device's idle share).

    python examples/profile_step_torch.py [--network gnmt|ds2] [--sl N]
                                          [--out DIR]

Prints a JSON summary and writes it to ``DIR/profile_step_<net>_sl<N>.json``.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.device import card_line
from repro_torch.kernels.lstm_cell import kernel
from repro_torch.models.rnn import DS2, GNMT, DS2Config, GNMTConfig

REPEATS = 3                     # as WallclockProvider in run_reproduction


def _device_time_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def build(network: str, sl: int):
    """The model, its step's batch and a description, as
    ``run_reproduction``'s setups build them."""
    if network == "gnmt":
        kernel.build()
        kernel.build_bwd()
        model = GNMT(GNMTConfig(), seed=0, device="cuda")
        return model, model.make_batch(sl, 16, sl, sl), 16, (
            "GNMTConfig() (d_model 1024, vocab 32000, 1 bi + 7 uni "
            "encoder, 8 decoder LSTM layers)")
    model = DS2(DS2Config(), seed=0, device="cuda")
    return model, model.make_batch(sl, 8, sl), 8, (
        "DS2Config() (161 frequency bins, 2 conv of 32 channels, 5 bi-GRU "
        "of 800, vocab 29, CTC)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", choices=("gnmt", "ds2"), default="gnmt")
    ap.add_argument("--sl", type=int, default=None,
                    help="padded SL (default 128 for gnmt, 1728 for ds2)")
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    sl = args.sl or (128 if args.network == "gnmt" else 1728)
    if not torch.cuda.is_available():
        sys.exit("profile_step_torch: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    model, batch, bsz, config = build(args.network, sl)
    params = list(model.parameters())

    def step():
        t0 = time.perf_counter()
        loss, _ = model.loss(batch)
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, params)
        new = [p.detach() - 1e-4 * g for p, g in zip(params, grads)]
        torch.cuda.synchronize()
        del new
        return t1 - t0, time.perf_counter() - t1, enqueued

    step()                                              # warmup
    fwd, bwd, enq = zip(*(step() for _ in range(REPEATS)))
    step_s = statistics.median(f + b for f, b in zip(fwd, bwd))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        launches0 = (kernel.launches, kernel.bwd_launches)
        t0 = time.perf_counter()
        step()
        traced_wall = time.perf_counter() - t0
        launches = (kernel.launches - launches0[0],
                    kernel.bwd_launches - launches0[1])
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = sorted(((e.key, _device_time_us(e), e.count) for e in kernels),
                     key=lambda r: -r[1])
    busy_us = sum(t for _, t, _ in by_name)
    summary = {
        "card": card, "network": args.network, "sl": sl, "batch": bsz,
        "config": config,
        "forward_s_median": statistics.median(fwd),
        "forward_enqueue_s_median": statistics.median(enq),
        "backward_s_median": statistics.median(bwd),
        "step_s_median": step_s,
        "repeats": REPEATS,
        "traced_step_s": traced_wall,
        "device_busy_s": busy_us * 1e-6 if by_name else None,
        # device busy time over the untraced step's wall time
        "device_busy_share": busy_us * 1e-6 / step_s if by_name else None,
        "device_launches": sum(c for _, _, c in by_name),
        "lstm_cell_launches": launches[0],
        "lstm_cell_bwd_launches": launches[1],
        "top_kernels": [{"name": n[:120], "device_ms": t / 1e3, "count": c}
                        for n, t, c in by_name[:12]],
    }
    print(json.dumps(summary, indent=1))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_step_{args.network}_sl{sl}"
                           ".json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
