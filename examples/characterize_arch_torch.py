"""SeqPoint-accelerated characterization of an assigned architecture on the
PyTorch port (the twin of ``examples/characterize_arch.py``).

For a production (arch, mesh, batch) and a document-length distribution,
answering "what does a full variable-SL training epoch cost?" takes one
trace of the sharded step per unique padded SL. This script (1) selects
SeqPoints from a cheap analytic runtime proxy, (2) traces only the
SeqPoint SLs on the single-pod mesh (one interleave period on fake
tensors, ``launch.dryrun.trace_cell``, scaled by the period count), and
(3) projects the epoch's time and per-device operations, with the trace
seconds saved: SeqPoint's §VI-F claim for a sharded model.

    PYTHONPATH=src python examples/characterize_arch_torch.py \\
        --arch qwen2-moe-a2.7b --samples 2048 [--device cpu]

It traces the card's path unless ``--device cpu`` is given. The proxy is
the reference example's, priced on its TPU_V5E peak (``select_seqpoints``'
error threshold sees absolute times, so the same constant selects the same
SLs); the projection prices the traced steps on the H100's bf16 peak and
its NVLink rate (``perfmodel.machine.H100_SXM_BF16``).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402


def proxy_seqpoints(arch: str, samples: int, batch: int, max_sl: int,
                    granularity: int):
    """Step (1): the epoch plan of ``samples`` documents drawn from
    ``lm_documents(max_sl)`` (seed 0) and the SeqPoints selected at a 2 %
    error threshold from the analytic proxy 6 * N_active * batch * SL per
    device at the reference's TPU_V5E peak. Returns (plan, SeqPointSet)."""
    from repro_torch.configs import SINGLE_POD, get_model_config
    from repro_torch.core import EpochLog, select_seqpoints
    from repro_torch.data.batching import plan_epoch
    from repro_torch.data.synthetic import lm_documents
    from repro_torch.perfmodel.machine import TPU_V5E
    from repro_torch.perfmodel.model_flops import param_count

    cfg = get_model_config(arch)
    rng = np.random.RandomState(0)
    sls = lm_documents(max_sl).sample(rng, samples)
    plan = plan_epoch(sls, batch, granularity=granularity)
    n_active = param_count(cfg, active=True)
    log = EpochLog()
    for sl in plan.padded_sls:
        t = 6 * n_active * batch * int(sl) / SINGLE_POD.num_devices \
            / TPU_V5E.peak_flops
        log.append(int(sl), t)
    return plan, select_seqpoints(log, error_threshold=0.02)


def trace_seqpoints(arch: str, seq_lens, batch: int, device: str) -> dict:
    """Step (2): each SeqPoint SL's train step at one interleave period,
    traced on the single-pod mesh and scaled by the period count:
    per-device operations, collective wire bytes and the step's roofline
    time on the H100."""
    import torch

    from repro_torch.configs import (
        SINGLE_POD,
        ShapeConfig,
        StepKind,
        get_model_config,
    )
    from repro_torch.launch.dryrun import (
        _n_periods,
        _reduced,
        default_run,
        fake_process_group,
        trace_cell,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.perfmodel.machine import H100_SXM_BF16

    cfg = get_model_config(arch)
    rcfg = _reduced(cfg, 1)
    n_periods = _n_periods(cfg)
    per_sl = {}
    with fake_process_group(SINGLE_POD.num_devices):
        mesh = make_mesh(SINGLE_POD, torch.device(device).type)
        for sl in seq_lens:
            shape = ShapeConfig(f"sl{sl}", seq_len=int(sl),
                                global_batch=batch, step=StepKind.TRAIN)
            t = trace_cell(rcfg, default_run(rcfg, shape, SINGLE_POD), mesh,
                           device)
            flops = t["flops"] * n_periods              # 1-period scaled
            coll = t["collectives"].wire_bytes * n_periods
            per_sl[int(sl)] = {"flops": flops, "coll": coll,
                               "t": max(flops / H100_SXM_BF16.peak_flops,
                                        coll / H100_SXM_BF16.ici_bw)}
    return per_sl


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--max-sl", type=int, default=4096)
    ap.add_argument("--granularity", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    plan, sp = proxy_seqpoints(args.arch, args.samples, args.batch,
                               args.max_sl, args.granularity)
    uniq = sorted(set(int(s) for s in plan.padded_sls))
    print(f"{args.arch}: epoch of {plan.num_batches} iterations, "
          f"{len(uniq)} unique padded SLs {uniq[:5]}...{uniq[-3:]}")
    print(f"SeqPoints: {sp.num_points} of {len(uniq)} unique SLs "
          f"-> trace {sp.num_points} instead of {len(uniq)} shapes")

    t0 = time.perf_counter()
    per_sl = trace_seqpoints(args.arch, sp.seq_lens, args.batch, args.device)
    trace_seconds = time.perf_counter() - t0

    total_t = sp.project_total(lambda s: per_sl[int(s)]["t"])
    total_f = sp.project_total(lambda s: per_sl[int(s)]["flops"])
    est_full = trace_seconds / sp.num_points * len(uniq)
    print(f"projected epoch: {total_t:.1f}s/epoch roofline-bound, "
          f"{total_f:.3g} per-device operations")
    print(f"profiling cost: {trace_seconds:.0f}s for "
          f"{sp.num_points} traces vs ~{est_full:.0f}s for all "
          f"{len(uniq)} unique SLs ({est_full/max(trace_seconds,1e-9):.1f}x"
          f" saved)")


if __name__ == "__main__":
    main()
