"""Analytic collective accounting (a copy of
``repro.dist.sharding.tp_activation_wire_bytes``; the sharding rules come
with the distribution slice)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def tp_activation_wire_bytes(cfg: ModelConfig, global_batch: int,
                             seq_len: int, tp: int, *,
                             dtype_bytes: int = 2,
                             training: bool = True) -> float:
    """Per-step on-the-wire bytes of the TP activation all-reduces.

    Megatron layout: 2 all-reduces of the (B, S, d) residual per block
    (attention output + FFN output), each ring all-reduce moving
    ``2*(tp-1)/tp`` bytes per buffer byte; backward doubles them. This is
    the SL-proportional communication term SeqPoint projects.
    """
    if tp <= 1:
        return 0.0
    buf = global_batch * seq_len * cfg.d_model * dtype_bytes
    per_block = 2 * buf * 2.0 * (tp - 1) / tp
    total = per_block * cfg.num_layers
    if training:
        total *= 2.0
    return float(total)
