"""Where the time of one full-width training step goes, on the CUDA card.

Builds starcoder2-3b at full width and depth (or ``--num-layers``) in the
reference RunConfig's dtypes (bf16 parameters and compute, fp32 AdamW
moments) and runs the port's own train step (``build_train_step``, the
step ``Trainer`` runs) at each padded SL given, batch 8, every label real:

1. untraced: whole steps, each ended by a synchronize, after one warmup
   step; the median of three;
2. traced with ``torch.profiler``: one step's device time by phase (the
   step's own ``train_step/*`` ranges: forward, backward, compress, adamw;
   a kernel counts to the range its launching op started in, whatever
   thread launched it) and by kernel name, the flash kernel's launches,
   and device busy time over the traced step's own wall time (its
   complement is the device's idle share; the trace's host overhead
   lowers the share); peak memory of the untraced steps.

    python examples/profile_train_torch.py [--sl 64 --sl 256]
                                           [--num-layers N] [--out DIR]

Prints a JSON summary and writes it to ``DIR/profile_train.json``.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    MeshConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
    get_model_config,
)
from repro_torch.data.synthetic import sample_tokens  # noqa: E402
from repro_torch.device import card_line  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    build_train_step,
    init_train_state,
)

REPEATS = 3
BATCH = 8
RANGE = "train_step/"


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def phase_split(events) -> dict:
    """Device microseconds by ``train_step/*`` range. Each host op carries
    the kernels it launched (its self device time); the op counts to the
    range whose host window holds its start. The backward's ops run on
    autograd's device thread while the calling thread waits inside its
    range, so windows, not parents, attribute them. Ops outside every
    range go to ``outside``."""
    windows = [(e.time_range.start, e.time_range.end, e.name[len(RANGE):])
               for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith(RANGE)]
    dev = {name: 0.0 for _, _, name in windows}
    dev["outside"] = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or e.name.startswith(RANGE):
            continue
        us = _device_us(e)
        if not us:
            continue
        where = next((n for s, t, n in windows
                      if s <= e.time_range.start <= t), "outside")
        dev[where] += us
    host = {}
    for s, t, name in windows:
        host[name] = host.get(name, 0.0) + (t - s)
    return {"device_us": dev, "host_us": host}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--sl", type=int, action="append")
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    sls = args.sl or [64, 256]
    if not torch.cuda.is_available():
        sys.exit("profile_train_torch: no CUDA device")
    card = card_line()
    cfg = get_model_config(args.arch)
    if args.num_layers:
        cfg = cfg.with_overrides(num_layers=args.num_layers)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", seq_len=max(sls), global_batch=BATCH, step=StepKind.TRAIN),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        optimizer=OptimizerConfig(lr=3e-4, warmup_steps=10))
    model = build_model(cfg, Runtime.from_run(run), device="cuda", seed=0)
    state = init_train_state(model, run)
    train_step = build_train_step(model, run)

    def step(batch) -> float:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"card": card, "arch": cfg.name, "num_layers": cfg.num_layers,
           "batch": BATCH, "param_dtype": run.param_dtype,
           "moment_dtype": run.optimizer.moment_dtype,
           "params_b": sum(t.numel() for t in state.params.values()) / 1e9,
           "by_sl": {}}
    rng = np.random.RandomState(0)
    for sl in sls:
        toks = sample_tokens(rng, (BATCH, sl + 1), cfg.vocab_size)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
                 "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
        step(batch)                                     # warmup
        torch.cuda.reset_peak_memory_stats()
        walls = [step(batch) for _ in range(REPEATS)]
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            launches0 = flash.launches
            traced = step(batch)
            launches = flash.launches - launches0
        split = phase_split(prof.events())
        # the device track also spans each range the calling thread
        # opened (a gpu_user_annotation): a span, not a kernel
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(RANGE)]
        by_name = sorted(((e.key, _device_us(e), e.count)
                          for e in kernels), key=lambda r: -r[1])
        busy_us = sum(t for _, t, _ in by_name)
        out["by_sl"][sl] = {
            "step_s_median": statistics.median(walls),
            "step_s": walls, "traced_step_s": traced,
            "phase_device_ms": {k: v / 1e3 for k, v in
                                split["device_us"].items()},
            "phase_host_ms_traced": {k: v / 1e3 for k, v in
                                     split["host_us"].items()},
            "device_busy_s": busy_us * 1e-6 if by_name else None,
            "device_busy_share": busy_us * 1e-6 / traced if by_name
            else None,
            "device_launches": sum(c for _, _, c in by_name),
            "flash_launches": launches,
            "peak_memory_gb": peak / 1e9,
            "top_kernels": [{"name": n[:120], "device_ms": t / 1e3,
                             "count": c} for n, t, c in by_name[:15]],
        }
        print(json.dumps({sl: {k: v for k, v in out["by_sl"][sl].items()
                               if k != "top_kernels"}}))
    print(json.dumps(out, indent=1))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_train.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
