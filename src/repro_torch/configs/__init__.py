"""Config registry: ``get_model_config(arch_id)`` + smoke reductions.

Copies of ``repro.configs``' registry and ``smoke_config``; the port keeps
its own so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.base import (
    MULTI_POD,
    SINGLE_POD,
    BlockKind,
    EncoderConfig,
    MLAConfig,
    MambaConfig,
    MeshConfig,
    MoEConfig,
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
)
from repro_torch.configs.shapes import ALL_SHAPES, get_shape, shapes_for

_REGISTRY: Dict[str, ModelConfig] = {m.name: m for m in ASSIGNED}


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_model_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[name]


def register(cfg: ModelConfig) -> ModelConfig:
    """Add ``cfg`` to the registry under its name (replacing one of that
    name) and return it."""
    _REGISTRY[cfg.name] = cfg
    return cfg


def smoke_config(name: str) -> ModelConfig:
    """Structure-preserving reduction for CPU smoke tests.

    Keeps the block pattern, family and every architectural mechanism (MoE,
    MLA, mamba, rwkv, enc-dec) while shrinking widths/depths/tables so a
    forward+backward step runs in well under a second on one CPU core.
    """
    cfg = get_model_config(name)
    period = cfg.interleave_period
    reduced = dict(
        num_layers=max(2 * period, 2),
        d_model=128,
        d_ff=256,
        vocab_size=512,
        max_position=4096,
    )
    if cfg.num_heads:
        reduced.update(num_heads=4, head_dim=32,
                       num_kv_heads=min(cfg.num_kv_heads, 4) or 4)
        # preserve the GQA grouping (kv < q) where the full arch has it
        if cfg.num_kv_heads < cfg.num_heads:
            reduced["num_kv_heads"] = 2
    if cfg.moe is not None:
        reduced["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            expert_d_ff=128)
    if cfg.mla is not None:
        reduced["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                   qk_nope_head_dim=32, qk_rope_head_dim=16,
                                   v_head_dim=32)
    if cfg.mamba is not None:
        reduced["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
    if cfg.encoder is not None:
        reduced["encoder"] = EncoderConfig(num_layers=2, max_source_len=64)
    return cfg.with_overrides(name=f"{name}-smoke", **reduced)


__all__ = [
    "ALL_SHAPES", "ASSIGNED", "BlockKind", "EncoderConfig", "MLAConfig",
    "MambaConfig", "MeshConfig", "MoEConfig", "ModelConfig", "MULTI_POD",
    "OptimizerConfig", "RunConfig", "ShapeConfig", "SINGLE_POD", "StepKind",
    "get_model_config", "get_shape", "list_archs", "register", "shapes_for",
    "smoke_config",
]
