#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit, from nvidia-smi;
2. kernels: builds the Hopper LSTM-cell kernel from its source and holds it
   against the plain PyTorch cell at GNMT's three cell shapes and a ragged
   one (fp32, rtol = atol = 3e-5, as the JAX package's kernel test); times
   the kernel, the plain cell and ``torch.lstm_cell`` (yardstick only);
3. main path: ``run_reproduction("gnmt")`` — the SeqPoint wallclock track —
   at the paper's full GNMT width and depth, with the kernel's launch count
   set to 0 just before and read just after; it must equal the number of
   LSTM timesteps the profiled steps run;
4. parity at full width: one SL-32 batch's loss and LSTM-weight gradients
   with the kernel against the plain cell (TF32 off for both).

It prints one JSON line with the kernels' numbers and, last, the device.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core.reproduction import run_reproduction  # noqa: E402
from repro_torch.kernels.lstm_cell import kernel  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402
from repro_torch.models.rnn import GNMT, GNMTConfig  # noqa: E402

TOL = 3e-5                    # kernel vs plain cell, rtol and atol
LOSS_RTOL = 1e-5              # GNMT loss, kernel vs plain cell
GRAD_REL = 1e-4               # max |dW_k - dW_p| / max |dW_p|
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 without tensor cores
# (name, B, D, H): the cell shapes of GNMT at its training batch, and a
# ragged one that fits no tile
CELL_SHAPES = [("enc_bi", 16, 1024, 512), ("enc_uni,dec1-7", 16, 1024, 1024),
               ("dec0", 16, 2048, 1024), ("ragged", 5, 77, 200)]
MAIN_SHAPE = "enc_uni,dec1-7"     # 14 of GNMT's 17 LSTM layers


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cell_bound_ms(b: int, k: int, h: int):
    """Least time for one cell: each input read once and each output
    written once at the HBM rate, or its fp32 operations at peak."""
    nbytes = 4 * (b * k + k * h * 4 + h * 4 + b * h + 2 * b * h)
    flops = 2 * b * k * 4 * h + b * 4 * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_phase() -> dict:
    t0 = time.perf_counter()
    kernel.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for name, b, d, h in CELL_SHAPES:
        k = d + h
        xh = torch.randn(b, k, device="cuda", generator=g)
        w = torch.randn(k, h, 4, device="cuda", generator=g) / math.sqrt(k)
        bias = torch.randn(h, 4, device="cuda", generator=g) * 0.1
        c = torch.randn(b, h, device="cuda", generator=g)
        hk, ck = kernel.lstm_cell_fwd(xh, w, bias, c)
        torch.cuda.synchronize()
        hp, cp = lstm_cell_ref(xh, w, bias, c)
        err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
        if not (torch.allclose(hk, hp, rtol=TOL, atol=TOL)
                and torch.allclose(ck, cp, rtol=TOL, atol=TOL)):
            raise RuntimeError(f"lstm_cell kernel disagrees with the plain "
                               f"cell at {name} {(b, d, h)}: {err}")
        # yardstick: torch.lstm_cell on PyTorch's gate-blocked layout, with
        # the forget gate's +1 folded into its bias
        w_ih = w[:d].permute(2, 1, 0).reshape(4 * h, d).contiguous()
        w_hh = w[d:].permute(2, 1, 0).reshape(4 * h, h).contiguous()
        b_ih = (bias + torch.tensor([0.0, 1.0, 0.0, 0.0], device="cuda")
                ).T.reshape(4 * h).contiguous()
        b_hh = torch.zeros_like(b_ih)
        x, hx = xh[:, :d].contiguous(), xh[:, d:].contiguous()
        hl, cl = torch.lstm_cell(x, (hx, c), w_ih, w_hh, b_ih, b_hh)
        lib_err = max((hl - hp).abs().max().item(),
                      (cl - cp).abs().max().item())
        bound, bound_by = cell_bound_ms(b, k, h)
        row = {
            "shape": name, "B": b, "D": d, "H": h, "max_abs_err": err,
            "ms": time_ms(lambda: kernel.lstm_cell_fwd(xh, w, bias, c)),
            "plain_ms": time_ms(lambda: lstm_cell_ref(xh, w, bias, c)),
            "library_ms": time_ms(lambda: torch.lstm_cell(
                x, (hx, c), w_ih, w_hh, b_ih, b_hh)),
            "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": bound_by,
        }
        print(f"lstm_cell {name} B={b} D={d} H={h}: max_abs_err {err:.3e} "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"torch.lstm_cell {row['library_ms']:.4f} ms, "
              f"bound {bound:.4f} ms ({bound_by})")
        shapes.append(row)
    return {r["shape"]: r for r in shapes}


def main_path_phase() -> int:
    cfg = GNMTConfig()
    kernel.launches = 0
    t0 = time.perf_counter()
    res = run_reproduction("gnmt", device="cuda", model_config=cfg,
                           force=True, tag="_chip_smoke")
    wall = time.perf_counter() - t0
    launches = kernel.launches
    layers = 2 + cfg.num_enc_uni + cfg.num_dec
    expected = (1 + 3) * layers * sum(res["unique_sls"])  # warmup + repeats
    print(f"main path: run_reproduction('gnmt') at GNMTConfig() "
          f"(d_model={cfg.d_model}, vocab={cfg.vocab_size}, 1 bi + "
          f"{cfg.num_enc_uni} uni encoder, {cfg.num_dec} decoder) on "
          f"{res['device']}: {res['num_iterations']} iterations, "
          f"{res['num_unique_sls']} unique SLs, {wall:.1f} s")
    for sl, t in sorted(res["wallclock"]["runtime_by_sl"].items(),
                        key=lambda kv: int(kv[0])):
        print(f"  step SL {int(sl):4d}: {1e3 * t:9.2f} ms")
    w = res["wallclock"]
    for name, m in w["methods"].items():
        print(f"  {name:9s}: {m['num_points']:3d} points, "
              f"error {m['error_pct']:.3f} %")
    sp = w["methods"]["seqpoint"]
    print(f"  epoch {w['total_epoch_seconds']:.3f} s; profiling "
          f"{w['profiling']['full_seconds']:.1f} s full vs "
          f"{w['profiling']['seqpoint_seconds']:.1f} s at SeqPoints")
    print(f"  lstm_cell launches: {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError(f"main path launched the LSTM kernel {launches} "
                           f"times, expected {expected}")
    times = list(w["runtime_by_sl"].values())
    if res["num_unique_sls"] < 4 or max(res["unique_sls"]) != 128:
        raise RuntimeError("main path profiled fewer than 4 SLs or not the "
                           "longest (128)")
    if not (all(math.isfinite(t) and t > 0 for t in times)
            and math.isfinite(sp["error_pct"])):
        raise RuntimeError(f"non-finite step time or SeqPoint error: {sp}")
    return launches


def parity_phase() -> None:
    model = GNMT(GNMTConfig(), seed=0, device="cuda")
    batch = model.make_batch(32, 16, 32, 32)
    names = ["enc_bi_b.w", "enc_uni.3.w", "dec.0.w", "dec.7.w"]
    params = dict(model.named_parameters())

    def run(use_kernel: bool):
        model.use_kernel = use_kernel
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.item(), grads

    loss_k, grads_k = run(True)
    loss_p, grads_p = run(False)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"parity at full width, SL 32: loss kernel {loss_k:.7f} plain "
          f"{loss_p:.7f} (rel {rel:.2e}, tol {LOSS_RTOL})")
    if not (math.isfinite(loss_k) and rel <= LOSS_RTOL):
        raise RuntimeError("GNMT loss with the kernel disagrees")
    for n, gk, gp in zip(names, grads_k, grads_p):
        gr = ((gk - gp).abs().max() / gp.abs().max()).item()
        print(f"  grad {n} {tuple(gk.shape)}: max|diff|/max|plain| "
              f"{gr:.2e} (tol {GRAD_REL})")
        if not gr <= GRAD_REL:
            raise RuntimeError(f"gradient of {n} with the kernel disagrees")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    cells = kernel_phase()
    launches = main_path_phase()
    parity_phase()

    main_row = cells[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell/kernel.py:44",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cells.values()),
        "ms": main_row["ms"], "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": {k: main_row[k] for k in ("B", "D", "H")},
        "shapes": list(cells.values()),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
