"""Whether a training run's loss at a learning rate rises because of the
port's kernels, the bf16 arithmetic or the learning rate itself, on the CUDA
card.

Trains one arch at full width, cut to ``--layers``, with
``chip_smoke.py``'s training set-up (AdamW after a 10-step warmup, fp32
moments, batch 8 of ``lm_documents(256)`` padded to 16s, one warm-up step at
lr 0 first, random weights from seed 0), by ``build_train_step``, once for
each ``--run``: ``DTYPE:PATH`` with DTYPE ``bf16`` (parameters and compute;
the reference RunConfig's) or ``fp32``, and PATH ``kernel`` (the flash
kernels forward and backward) or ``plain`` (the plain attention and its
autograd). Every run starts from the same weights and sees the same batches.
A run that runs out of the card's memory is recorded as such and the next
one goes on.

    python examples/lr_witness_torch.py --arch mistral-nemo-12b --layers 10 \\
        --lr 3e-4 --run bf16:kernel --run bf16:plain --run fp32:kernel

Prints the card's line and one JSON line a run (losses, peak memory, flash
launches), and writes them all to ``--out``.
"""
import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    MeshConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
    get_model_config,
)
from repro_torch.data.batching import DataIterator  # noqa: E402
from repro_torch.data.synthetic import lm_documents  # noqa: E402
from repro_torch.device import card_line  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    build_train_step,
    init_train_state,
)

BATCH = 8
MAX_SL = 256


def _batches(cfg, device):
    it = DataIterator(lm_documents(MAX_SL), samples_per_epoch=4096,
                      batch_size=BATCH, vocab_size=cfg.vocab_size,
                      granularity=16, seed=0)
    for tokens, labels, _ in it:
        yield {k: torch.as_tensor(v, dtype=torch.long, device=device)
               for k, v in (("tokens", tokens), ("labels", labels))}


def train(cfg, dtype: str, path: str, lr: float, steps: int) -> dict:
    """``steps`` steps of ``cfg`` in ``dtype`` on ``path``; the losses."""
    kw = {} if dtype == "bf16" else {"param_dtype": "float32",
                                     "compute_dtype": "float32"}
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train", seq_len=MAX_SL, global_batch=BATCH, step=StepKind.TRAIN),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        optimizer=OptimizerConfig(lr=lr, warmup_steps=10), **kw)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": dtype,
           "path": path, "lr": lr, "steps": steps}
    model = state = step = None
    try:
        model = build_model(cfg, Runtime.from_run(run), device="cuda",
                            seed=run.seed)
        model.use_kernel = path == "kernel"
        batches = _batches(cfg, model.device)
        # one warm-up step at lr 0 (the warmup's first), as chip_smoke's
        build_train_step(model, run, steps)(init_train_state(model, run),
                                            next(_batches(cfg, model.device)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash.launches = flash.bwd_launches = 0
        state = init_train_state(model, run)
        step = build_train_step(model, run, steps)
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step(state, next(batches))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics.get("grad_norm", float("nan"))))
        out.update(
            status="ok", losses=losses, grad_norms=norms,
            loss_mean_first5=float(np.mean(losses[:5])),
            loss_mean_last5=float(np.mean(losses[-5:])),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            flash_launches=flash.launches,
            flash_bwd_launches=flash.bwd_launches)
    except torch.cuda.OutOfMemoryError as e:
        out.update(status="out of memory", error=str(e).splitlines()[0])
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--layers", type=int, action="append", required=True,
                    help="one depth, or one a --run")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--run", action="append", required=True,
                    help="DTYPE:PATH, bf16|fp32 : kernel|plain")
    ap.add_argument("--out", default="chiprun_out/lr_witness.json")
    args = ap.parse_args()
    layers = args.layers * len(args.run) if len(args.layers) == 1 \
        else args.layers
    if len(layers) != len(args.run):
        raise SystemExit("give one --layers, or one a --run")
    if not torch.cuda.is_available():
        raise SystemExit("lr_witness: needs a CUDA card")
    line = card_line()
    print(line, flush=True)
    recs = []
    for n, spec in zip(layers, args.run):
        dtype, path = spec.split(":")
        cfg = get_model_config(args.arch).with_overrides(num_layers=n)
        rec = dict(train(cfg, dtype, path, args.lr, args.steps), card=line)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
