"""Assigned input-shape sets (see assignment block / DESIGN.md).

LM transformer shapes are seq_len x global_batch. ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), not
``train_step``. ``long_500k`` applies only to sub-quadratic archs.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig, StepKind

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256,
                       step=StepKind.TRAIN)
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32,
                          step=StepKind.PREFILL)
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128,
                         step=StepKind.DECODE)
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                        step=StepKind.DECODE)

ALL_SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shapes_for(model: ModelConfig) -> List[ShapeConfig]:
    """The assigned shape cells for one architecture.

    ``long_500k`` needs sub-quadratic sequence mixing; pure full-attention
    archs skip it (recorded in DESIGN.md §7). Enc-dec archs have a decoder, so
    decode shapes run.
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if model.subquadratic:
        out.append(LONG_500K)
    return out


def get_shape(name: str) -> ShapeConfig:
    return ALL_SHAPES[name]
