"""Config dataclasses of the model zoo (copies of ``repro.configs.base``).

Every architecture is described by a ``ModelConfig``; a ``ShapeConfig`` is a
(seq_len x global_batch x step kind) cell. Configs are plain frozen
dataclasses so they hash, compare and serialize trivially. A
``MeshConfig`` names the device mesh the run is laid out on, an
``OptimizerConfig`` the AdamW step and a ``RunConfig`` one training run.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple


class BlockKind(str, enum.Enum):
    """Kind of a residual block in the layer stack."""

    ATTENTION = "attention"        # GQA/MHA self-attention
    MLA = "mla"                    # DeepSeek multi-head latent attention
    MAMBA = "mamba"                # Mamba-1 selective SSM (jamba)
    RWKV = "rwkv"                  # RWKV-6 time-mix (attention-free)
    DENSE_FFN = "dense_ffn"
    MOE_FFN = "moe_ffn"
    RWKV_CHANNEL = "rwkv_channel"  # RWKV-6 channel-mix


class StepKind(str, enum.Enum):
    TRAIN = "train"          # full fwd+bwd+update
    PREFILL = "prefill"      # fwd, build KV cache
    DECODE = "decode"        # one token vs. existing cache/state


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int            # top-k routed
    num_shared_experts: int = 0
    expert_d_ff: Optional[int] = None  # per-expert hidden dim (defaults d_ff)
    capacity_factor: float = 1.25      # capacity-bounded dispatch (TPU style)
    router_aux_coef: float = 0.001
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims (arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        """Width of a query or key head: the no-rope and rope parts."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                    # d_inner = expand * d_model


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (whisper). Frontend is a stub that
    consumes precomputed frame embeddings per the assignment."""

    num_layers: int = 24
    max_source_len: int = 1500         # whisper: 30s @ 50 Hz after conv stub


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # moe|dense|vlm|hybrid|audio|ssm|rnn
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0                 # 0 => attention-free arch
    num_kv_heads: int = 0
    head_dim: int = 0                  # 0 => d_model // num_heads
    # Layer pattern: sequence of (mixer kind, ffn kind) repeated over depth.
    # Default: uniform attention + ffn. jamba overrides with 1:7 attn:mamba.
    block_pattern: Tuple[Tuple[BlockKind, BlockKind], ...] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    encoder: Optional[EncoderConfig] = None
    # --- attention details ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False             # qwen2 uses QKV bias
    causal: bool = True
    max_position: int = 131072
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # multi-token prediction heads (deepseek-v3 MTP); 0 = disabled
    mtp_depth: int = 0
    # modality frontend stub: number of embedding inputs replacing tokens
    frontend: Optional[str] = None     # None | "audio_frames" | "image_patches"
    act: str = "silu"
    # rwkv6 specifics
    rwkv_head_dim: int = 64

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def pattern(self) -> Tuple[Tuple[BlockKind, BlockKind], ...]:
        if self.block_pattern:
            return self.block_pattern
        mixer = BlockKind.ATTENTION
        ffn = BlockKind.MOE_FFN if self.moe is not None else BlockKind.DENSE_FFN
        return ((mixer, ffn),)

    @property
    def interleave_period(self) -> int:
        return len(self.pattern)

    @property
    def attention_free(self) -> bool:
        kinds = {m for m, _ in self.pattern}
        return BlockKind.ATTENTION not in kinds and BlockKind.MLA not in kinds

    @property
    def subquadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts (SSM/hybrid/linear)."""
        kinds = {m for m, _ in self.pattern}
        if kinds & {BlockKind.MAMBA, BlockKind.RWKV}:
            return True
        return False

    def with_overrides(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        def enc(o: Any) -> Any:
            if isinstance(o, enum.Enum):
                return o.value
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            raise TypeError(o)

        return json.dumps(dataclasses.asdict(self), default=enc, sort_keys=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: StepKind
    # decode shapes: KV cache holds seq_len tokens, one new token is decoded.
    # enc-dec: source_len drives the encoder, seq_len the decoder.
    source_len: int = 0


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_degree(self) -> int:
        d = 1
        for s, a in zip(self.shape, self.axes):
            if a in ("pod", "data"):
                d *= s
        return d

    @property
    def model_degree(self) -> int:
        for s, a in zip(self.shape, self.axes):
            if a == "model":
                return s
        return 1


SINGLE_POD = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # dtype of first/second moments; bf16 moments halve the optimizer state
    moment_dtype: str = "float32"
    # gradient all-reduce compression: none | bf16 | int8_ef | topk_ef
    grad_compression: str = "none"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD
    optimizer: OptimizerConfig = OptimizerConfig()
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # fsdp: shard params + optimizer state over the data axis too (ZeRO-3-ish)
    fsdp: bool = False
    # extend FSDP across the pod (DCN) axis
    fsdp_over_pods: bool = False
    # 3 = params+grads+opt sharded (gathers per microbatch);
    # 1 = opt state only (params TP-resident; one gather/reduce per step)
    zero_stage: int = 3
    remat: str = "none"                # none | block | full
    microbatches: int = 1              # gradient accumulation
    seed: int = 0
    # scan unrolling for dry-run cost analysis
    unroll_layers: int = 0             # 0 = rolled
    attn_chunk: int = 0                # 0 = auto (chunked above threshold)
    use_pallas: bool = False           # read nowhere, as in the reference
    # experts sharded over (data x model) with all-to-all dispatch
    moe_full_ep: bool = False
    # "tp" (default) | "dp_only": map the whole mesh to data parallelism
    parallelism: str = "tp"
