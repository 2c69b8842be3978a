"""The ten assigned architectures, exact published dims.

Sources per the assignment block ([arXiv/hf; tier] annotations there). Each
config is consumed by ``repro_torch.models.model_zoo.build_model``;
copied exactly from ``repro.configs.archs``.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    BlockKind as BK,
    EncoderConfig,
    MLAConfig,
    MambaConfig,
    MoEConfig,
    ModelConfig,
)

# --- deepseek-v3-671b [arXiv:2412.19437] -----------------------------------
# MLA attention (latent kv), 1 shared + 256 routed experts top-8, MTP head.
# Assignment pins d_ff=2048 (the MoE expert intermediate); every layer is MoE
# per the assignment string (the HF release keeps 3 dense lead-in layers —
# noted in DESIGN.md §8).
DEEPSEEK_V3_671B = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, d_ff=2048, vocab_size=129_280,
    num_heads=128, num_kv_heads=128, head_dim=128,
    moe=MoEConfig(num_experts=256, experts_per_token=8, num_shared_experts=1,
                  expert_d_ff=2048),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    block_pattern=((BK.MLA, BK.MOE_FFN),),
    mtp_depth=1, rope_theta=10_000.0,
)

# --- qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B] ---------------------------
QWEN2_MOE_A2_7B = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, d_ff=1408, vocab_size=151_936,
    num_heads=16, num_kv_heads=16,
    moe=MoEConfig(num_experts=60, experts_per_token=4, num_shared_experts=4,
                  expert_d_ff=1408),
    qkv_bias=True, rope_theta=1_000_000.0,
)

# --- mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407] ----------------
# head_dim=128 is decoupled from d_model (32 heads x 128 = 4096 != 5120).
MISTRAL_NEMO_12B = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, d_ff=14_336, vocab_size=131_072,
    num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=1_000_000.0, max_position=131_072,
)

# --- internlm2-20b [arXiv:2403.17297] --------------------------------------
INTERNLM2_20B = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, d_ff=16_384, vocab_size=92_544,
    num_heads=48, num_kv_heads=8,
    rope_theta=1_000_000.0,
)

# --- qwen2-72b [arXiv:2407.10671] ------------------------------------------
QWEN2_72B = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, d_ff=29_568, vocab_size=152_064,
    num_heads=64, num_kv_heads=8, qkv_bias=True,
    rope_theta=1_000_000.0,
)

# --- starcoder2-3b [arXiv:2402.19173] --------------------------------------
STARCODER2_3B = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, d_ff=12_288, vocab_size=49_152,
    num_heads=24, num_kv_heads=2,
    rope_theta=999_999.4,
)

# --- llava-next-34b [hf:llava-hf/llava-v1.6-*] -----------------------------
# VLM: transformer backbone only; anyres image patches arrive as precomputed
# patch embeddings through the frontend stub (assignment rule).
LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, d_ff=20_480, vocab_size=64_000,
    num_heads=56, num_kv_heads=8,
    rope_theta=5_000_000.0, frontend="image_patches",
)

# --- jamba-v0.1-52b [arXiv:2403.19887] -------------------------------------
# Mamba:attention 7:1 (attn at offset 4 of every 8), MoE every other layer
# (offset 1 of every 2), 16 experts top-2.
_JAMBA_PATTERN = tuple(
    (BK.ATTENTION if i == 4 else BK.MAMBA,
     BK.MOE_FFN if i % 2 == 1 else BK.DENSE_FFN)
    for i in range(8)
)
JAMBA_V01_52B = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, d_ff=14_336, vocab_size=65_536,
    num_heads=32, num_kv_heads=8,
    block_pattern=_JAMBA_PATTERN,
    moe=MoEConfig(num_experts=16, experts_per_token=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

# --- whisper-medium [arXiv:2212.04356] -------------------------------------
# Enc-dec; conv frontend is a stub feeding precomputed frame embeddings
# (1500 frames = 30 s). num_layers counts decoder layers; the encoder stack is
# symmetric (24 layers).
WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, d_ff=4096, vocab_size=51_865,
    num_heads=16, num_kv_heads=16,
    encoder=EncoderConfig(num_layers=24, max_source_len=1500),
    frontend="audio_frames", act="gelu", max_position=40_960,
)

# --- rwkv6-3b (Finch) [arXiv:2404.05892] -----------------------------------
# Attention-free: time-mix with data-dependent decay + channel-mix.
RWKV6_3B = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, d_ff=8960, vocab_size=65_536,
    num_heads=0, num_kv_heads=0,
    block_pattern=((BK.RWKV, BK.RWKV_CHANNEL),),
    rwkv_head_dim=64,
)

ASSIGNED = (
    DEEPSEEK_V3_671B, QWEN2_MOE_A2_7B, MISTRAL_NEMO_12B, INTERNLM2_20B,
    QWEN2_72B, STARCODER2_3B, LLAVA_NEXT_34B, JAMBA_V01_52B,
    WHISPER_MEDIUM, RWKV6_3B,
)
