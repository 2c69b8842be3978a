"""Train launcher (a port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --smoke --steps 50 [--ckpt-dir build/ck] [--device cpu]

``--smoke`` uses the structure-preserving reduced config (CPU-runnable);
without it the full assigned config is built. It runs on the CUDA card
unless ``--device cpu`` is given. The SL schedule is logged and SeqPoints
are reported at the end, so every training run doubles as a profiling
artifact.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--bucketed", action="store_true",
                    help="SL-bucketed batching (beyond-paper opt)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--compute-dtype", default="float32")
    args = ap.parse_args(argv)

    from repro_torch.configs import (
        MeshConfig,
        OptimizerConfig,
        RunConfig,
        ShapeConfig,
        StepKind,
        get_model_config,
        smoke_config,
    )
    from repro_torch.data.batching import DataIterator
    from repro_torch.data.synthetic import lm_documents
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.trainer import Trainer

    cfg = smoke_config(args.arch) if args.smoke \
        else get_model_config(args.arch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        step=StepKind.TRAIN)
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig(shape=(1,), axes=("data",)),
                    optimizer=OptimizerConfig(lr=3e-4, warmup_steps=10),
                    param_dtype=args.param_dtype,
                    compute_dtype=args.compute_dtype)
    model = build_model(cfg, Runtime.from_run(run), device=args.device,
                        seed=run.seed)
    data = DataIterator(lm_documents(args.seq), samples_per_epoch=4096,
                        batch_size=args.batch, vocab_size=cfg.vocab_size,
                        granularity=16, bucketed=args.bucketed, seed=0)
    trainer = Trainer(model, run, data, ckpt_dir=args.ckpt_dir,
                      total_steps=args.steps)
    rep = trainer.train(args.steps)
    print(f"arch={cfg.name} device={model.device} steps={rep.steps} "
          f"resumed_from={rep.resumed_from} "
          f"loss {rep.losses[0]:.3f}->{rep.losses[-1]:.3f} "
          f"median_step_ms={1e3*np.median(rep.step_times):.1f}")
    sp = trainer.seqpoints(error_threshold=0.05)
    print(f"seqpoints={sp.num_points} sls={sp.seq_lens} "
          f"error={100*sp.error:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
