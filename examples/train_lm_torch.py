"""End-to-end example of the PyTorch port: train a ~110M-param LM for a few
hundred steps with variable-SL batches, checkpoints + auto-resume, and
SeqPoint logging (the twin of ``examples/train_lm.py``).

    python examples/train_lm_torch.py --steps 300 [--device cpu]
                                      [--ckpt-dir build/train_lm_torch]

It runs on the CUDA card unless ``--device cpu`` is given. With
``--ckpt-dir`` it checkpoints every 50 steps there: kill it mid-run and
re-run with the same directory, and it resumes from the last checkpoint.
Without it nothing is written.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
)
from repro_torch.data.batching import DataIterator  # noqa: E402
from repro_torch.data.synthetic import lm_documents  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.perfmodel.model_flops import param_count  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = ModelConfig(
        name="lm-110m", family="dense", num_layers=args.layers,
        d_model=args.d_model, d_ff=4 * args.d_model, vocab_size=32_000,
        num_heads=args.d_model // 64, num_kv_heads=args.d_model // 64 // 2)
    print(f"model: {param_count(cfg)/1e6:.0f}M params (non-embedding)")

    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        step=StepKind.TRAIN)
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig(shape=(1,), axes=("data",)),
                    optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20),
                    param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, Runtime.from_run(run), device=args.device,
                        seed=run.seed)
    data = DataIterator(lm_documents(args.seq), samples_per_epoch=4096,
                        batch_size=args.batch, vocab_size=cfg.vocab_size,
                        granularity=32, seed=0)
    trainer = Trainer(model, run, data, ckpt_dir=args.ckpt_dir,
                      ckpt_every=50, total_steps=args.steps)
    report = trainer.train(args.steps)
    print(f"steps={report.steps} resumed_from={report.resumed_from} "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"median_step={1e3*np.median(report.step_times):.0f}ms "
          f"stragglers={report.stragglers}")
    sp = trainer.seqpoints(error_threshold=0.05)
    print(f"SeqPoints for this run: {sp.num_points} SLs {sp.seq_lens} "
          f"(error {100*sp.error:.2f}%)")


if __name__ == "__main__":
    main()
