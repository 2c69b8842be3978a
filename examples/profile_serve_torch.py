"""Where the time of serving goes, on the CUDA card.

Builds the port's ``--arch`` (any decoder-only arch of ``configs/archs.py``:
starcoder2-3b by default, rwkv6-3b, jamba-v0.1-52b, qwen2-moe-a2.7b,
mistral-nemo-12b, internlm2-20b, qwen2-72b, llava-next-34b or
deepseek-v3-671b, the last without its MTP head, which serving never runs)
at full width in bf16, at full depth or ``--num-layers``, with random
weights from seed 0 and serves one batch as ``ServeEngine._execute`` does: a
prefill of ``--batch`` prompts at padded width ``--width``, then greedy
decode steps against a ``--max-len`` cache.

1. untraced: prefill and decode-step wall times, each ended by a
   synchronize (medians of ``--repeats`` prefills and ``--steps`` steps);
2. traced with ``torch.profiler``, once for a prefill and once for the
   decode steps: device time summed by kernel name, the hand-written
   kernels' launches (flash attention, WKV6, the selective scan), device
   busy time over the traced wall time (its complement is the device's
   idle share) and, for an MoE arch, the device time of the kernels its MoE
   layers launch (the profiler range that ``models/moe.py::moe_forward``
   opens on every call; the script fails if a call lacks it) beside the
   time to read every expert's weights (shared ones too) once at 3.35
   TB/s.

    python examples/profile_serve_torch.py [--arch jamba-v0.1-52b]
        [--num-layers 16] [--width 1536] [--top 12] [--out DIR]

The archs too large for one 80 GB card in bf16 need ``--num-layers``:
jamba-v0.1-52b 16, qwen2-72b 36, deepseek-v3-671b 2.

Prints a JSON summary and writes it to
``DIR/profile_serve_<ARCH>_l<LAYERS>_w<WIDTH>.json``.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_model_config, list_archs
from repro_torch.device import card_line
from repro_torch.configs.base import BlockKind as BK
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.mamba_scan import kernel as mamba
from repro_torch.kernels.rwkv6_wkv import kernel as wkv6
from repro_torch.models import moe
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import BF16

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def _device_time_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


KERNELS = {"flash_attention": flash, "wkv6": wkv6, "mamba_scan": mamba}


def _launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _traced(fn, top: int):
    """Run ``fn`` under the profiler: (wall s, the ``top`` kernels by device
    time)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the MoE range shows on the device too (a user annotation spanning
    # its kernels and the gaps between them): it is not a kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != moe.PROFILE_RANGE]
    by_name = sorted(((e.key, _device_time_us(e), e.count) for e in kernels),
                     key=lambda r: -r[1])
    busy_s = sum(t for _, t, _ in by_name) * 1e-6
    ranges = [e for e in prof.events() if e.name == moe.PROFILE_RANGE
              and e.device_type == torch.autograd.DeviceType.CPU]
    moe_s = 1e-6 * sum(float(getattr(e, "device_time_total", 0.0))
                       for e in ranges)
    return {"traced_wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall, "moe_device_s": moe_s,
            "moe_calls": len(ranges),
            "top_kernels": [{"name": n[:240], "device_ms": t / 1e3,
                             "count": c} for n, t, c in by_name[:top]]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b",
                    choices=[a for a in list_archs()
                             if get_model_config(a).encoder is None])
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the depth (jamba-v0.1-52b fits one card at "
                         "16 of its 32 layers); 0 keeps it")
    ap.add_argument("--width", type=int, default=1536)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--top", type=int, default=12,
                    help="kernels listed by device time in each trace")
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_serve_torch: no CUDA device")
    card = card_line()

    cfg = get_model_config(args.arch).with_overrides(mtp_depth=0)
    if args.num_layers:
        cfg = cfg.with_overrides(num_layers=args.num_layers)
    model = build_model(cfg, BF16, device="cuda", seed=0)
    rng = np.random.RandomState(0)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size,
                                       (args.batch, args.width)),
                           device="cuda")
    w = args.width

    def prefill():
        return model.prefill({"tokens": toks})

    def fresh_cache():
        logits, pre = prefill()
        cache = model.init_cache(args.batch, args.max_len, prefix=pre)
        return logits[:, -1].argmax(dim=-1)[:, None], cache

    def decode(tok, cache, n):
        times = []
        for step in range(n):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok, w + step)
            tok = logits.argmax(dim=-1)[:, None]
            tok[:, 0].tolist()                       # synchronizes
            times.append(time.perf_counter() - t0)
        return times

    with torch.inference_mode():
        prefill()                                    # warmup
        torch.cuda.synchronize()
        pre_s = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            pre_s.append(time.perf_counter() - t0)
        tok, cache = fresh_cache()
        decode(tok, cache, 2)                        # warmup
        tok, cache = fresh_cache()
        dec_s = decode(tok, cache, args.steps)

        before = _launches()
        pre_trace = _traced(prefill, args.top)
        mid = _launches()
        tok, cache = fresh_cache()
        after_fill = _launches()
        dec_trace = _traced(lambda: decode(tok, cache, args.steps),
                            args.top)
        end = _launches()

    moe_layers = sum(cfg.pattern[i % len(cfg.pattern)][1] == BK.MOE_FFN
                     for i in range(cfg.num_layers))
    expert_bytes = 0
    if moe_layers:
        m = cfg.moe
        expert_bytes = moe_layers * 3 * (
            m.num_experts + m.num_shared_experts) * cfg.d_model * (
            m.expert_d_ff or cfg.d_ff) * 2            # bf16
    # every MoE layer's call, per prefill and per decode step, must show
    # as a range with device time, or the MoE time below would read short
    for trace, calls in ((pre_trace, moe_layers),
                         (dec_trace, moe_layers * args.steps)):
        if trace["moe_calls"] != calls or (calls and not
                                           trace["moe_device_s"] > 0):
            raise RuntimeError(
                f"{trace['moe_calls']} {moe.PROFILE_RANGE} ranges with "
                f"{trace['moe_device_s']} s of device time, expected "
                f"{calls} calls")
    summary = {
        "card": card, "arch": cfg.name, "num_layers": cfg.num_layers,
        "dtype": "bfloat16",
        "batch": args.batch, "width": w, "max_len": args.max_len,
        "prefill_s_median": statistics.median(pre_s),
        "prefill_repeats": args.repeats,
        "decode_step_s_median": statistics.median(dec_s),
        "decode_steps": args.steps,
        "kernel_launches_per_prefill": {
            n: mid[n] - before[n] for n in KERNELS},
        "kernel_launches_per_decode_step": {
            n: (end[n] - after_fill[n]) / args.steps for n in KERNELS},
        "prefill_trace": pre_trace,
        "decode_trace": dec_trace,
        "moe_layers": moe_layers,
        "moe_device_ms_per_decode_step":
            1e3 * dec_trace["moe_device_s"] / args.steps,
        "moe_expert_weight_read_floor_ms":
            1e3 * expert_bytes / HBM_BYTES_PER_S,
    }
    print(json.dumps(summary, indent=1))
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, f"profile_serve_{args.arch}_l"
                       f"{cfg.num_layers}_w{w}.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
