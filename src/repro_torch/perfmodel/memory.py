"""Structural memory estimate per cell, a copy of
``repro.perfmodel.memory`` (the reference's ``structural_*`` fields, priced
for its 16 GiB target).

The dry run records it beside the fake-tensor trace's measured peak: the
analytic per-device estimate a fleet would budget,

  params + optimizer state (exact, = argument bytes)
  + remat checkpoints (train):  L x (B/dp/nmicro) x S x d x 2
  + per-layer working set:      attention scores / MoE dispatch buffers
  + KV caches (serve, exact)
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (
    BlockKind as BK,
    MeshConfig,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
)


def structural_memory(run: RunConfig, argument_bytes: int) -> Dict[str, float]:
    cfg, shape, mesh = run.model, run.shape, run.mesh
    dp = mesh.data_degree
    tp = mesh.model_degree
    b_loc = max(shape.global_batch // dp, 1)
    nmicro = max(run.microbatches, 1)
    s = shape.seq_len
    d = cfg.d_model

    ckpt = 0.0
    work = 0.0
    if shape.step == StepKind.TRAIN:
        b_mic = max(b_loc // nmicro, 1)
        ckpt = cfg.num_layers * b_mic * s * d * 2
        # attention score working set (fp32), q-heads sharded over model
        if not cfg.attention_free:
            h_loc = max(cfg.num_heads // tp, 1)
            chunk = min(s, 2048)
            work += b_mic * h_loc * s * chunk * 4 * 2
        # grad accumulators (fp32 shards) are counted in arguments? no —
        # they are temps of the step: params_fp32 / shards
        work += argument_bytes * 0.4          # fp32 grad accum + update temps
    else:
        h_loc = max((cfg.num_heads or 1) // tp, 1)
        work += shape.global_batch // max(dp, 1) * h_loc * s * 4 * 4
    total = argument_bytes + ckpt + work
    return {"ckpt_bytes": ckpt, "working_bytes": work,
            "structural_bytes": total,
            "fits_v5e_16g_structural": bool(total < 16 * 2**30)}
