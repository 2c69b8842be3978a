"""Parameter counts from the config (a copy of
``repro.perfmodel.model_flops.param_count``; the analytic MODEL_FLOPS
come with the distribution slice)."""
from __future__ import annotations

from repro_torch.configs.base import BlockKind as BK
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import padded_vocab


def _block_params(cfg: ModelConfig, kinds, active: bool) -> int:
    mixer, ffn = kinds
    d, dh = cfg.d_model, cfg.resolved_head_dim
    n = 0
    if mixer == BK.ATTENTION:
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        n += d * hq * dh * 2 + d * hkv * dh * 2
    elif mixer == BK.MLA:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        n += (d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
              + d * m.kv_lora_rank + d * m.qk_rope_head_dim
              + m.kv_lora_rank * cfg.num_heads
              * (m.qk_nope_head_dim + m.v_head_dim)
              + cfg.num_heads * m.v_head_dim * d)
    elif mixer == BK.MAMBA:
        di = cfg.mamba.expand * d
        dtr = max(d // 16, 8)
        n += (d * 2 * di + cfg.mamba.d_conv * di
              + di * (dtr + 2 * cfg.mamba.d_state) + dtr * di + di * d)
    elif mixer == BK.RWKV:
        da = (d // cfg.rwkv_head_dim) * cfg.rwkv_head_dim
        n += 5 * d * da + 64 * (d + da)
    if ffn == BK.DENSE_FFN:
        n += 3 * d * cfg.d_ff
    elif ffn == BK.MOE_FFN:
        m = cfg.moe
        f = m.expert_d_ff or cfg.d_ff
        per_expert = 3 * d * f
        if active:
            n += per_expert * m.experts_per_token
        else:
            n += per_expert * m.num_experts
        n += per_expert * m.num_shared_experts + d * m.num_experts
    elif ffn == BK.RWKV_CHANNEL:
        n += 2 * d * cfg.d_ff + d * d
    return n


def param_count(cfg: ModelConfig, active: bool = False) -> int:
    """Non-embedding params (+ LM head); MoE experts scaled to top-k when
    ``active``."""
    per_period = sum(_block_params(cfg, kinds, active)
                     for kinds in cfg.pattern)
    n = per_period * (cfg.num_layers // cfg.interleave_period)
    if cfg.encoder is not None:
        d = cfg.d_model
        enc_layer = 4 * d * d * (1 if cfg.num_kv_heads == cfg.num_heads
                                 else 1) + 2 * d * cfg.d_ff
        dec_extra = 4 * d * d + 0  # cross-attn
        n = (cfg.encoder.num_layers * enc_layer
             + cfg.num_layers * (enc_layer + dec_extra))
    n += cfg.d_model * padded_vocab(cfg.vocab_size)       # head
    if cfg.mtp_depth:
        n += (_block_params(cfg, cfg.pattern[0], active)
              + 2 * cfg.d_model * cfg.d_model)
    return n
