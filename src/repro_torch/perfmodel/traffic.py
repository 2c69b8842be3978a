"""Analytic per-device HBM traffic model (roofline memory term), a copy of
``repro.perfmodel.traffic``.

The dry run's memory term is this model, as in the reference, so the two
packages' roofline terms are equal by construction: a fake-tensor trace
counts operations exactly but moves no bytes, and the reference's own
measured number (XLA-CPU ``bytes accessed``) is inflated by bf16 -> f32
promotion and unfused elementwise chains. Fidelity target +-2x.

Model (train, per device, per step):
  weights     nmicro * 3 reads of the TP-resident compute weights
              (fwd + dW + dx passes)
  fsdp        + gather write+read per microbatch per pass when ZeRO-3
  optimizer   p (r+w) + m,v (r+w) + grad accumulator (r+w per microbatch)
  activations ACT_RT round-trips of (B_mic, S, d) per layer per pass-set
              (fwd, recompute, bwd with remat=block)
  attention   flash KV re-streams: ceil(S/BQ) reads of the KV block rows
  logits      (B_mic, S, V/tp) write + read, fp32, per microbatch
Serve steps: weights once + cache traffic + activations once.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    BlockKind as BK,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
)
from repro_torch.models.layers import padded_vocab
from repro_torch.perfmodel.model_flops import param_count

ACT_RT = 8            # activation round-trips per layer per pass
FLASH_BQ = 2048       # q-block rows per KV re-stream


def _bytes_of(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[dtype]


def hbm_traffic(run: RunConfig) -> float:
    cfg, shape, mesh = run.model, run.shape, run.mesh
    tp = mesh.model_degree if run.parallelism == "tp" else 1
    dp = mesh.data_degree if run.parallelism == "tp" else mesh.num_devices
    dev = mesh.num_devices
    nmicro = max(run.microbatches, 1)
    pb = _bytes_of(run.param_dtype)
    n_total = param_count(cfg, active=False)
    if run.moe_full_ep:
        # experts fully sharded over (data x model): per-device expert slice
        n_nonexp = param_count(cfg, active=True)
        w_compute = (n_nonexp / tp + (n_total - n_nonexp) / dev) * pb
    else:
        w_compute = n_total * pb / tp             # TP/EP-resident weights
    s, d = shape.seq_len, cfg.d_model
    b_loc = max(shape.global_batch // dp, 1)
    vp = padded_vocab(cfg.vocab_size)

    if shape.step == StepKind.TRAIN:
        b_mic = max(b_loc // nmicro, 1)
        passes = 3                                 # fwd + dW + dx
        t = nmicro * passes * w_compute
        if run.fsdp and run.zero_stage >= 3:
            # ZeRO-3: per-microbatch gather materializes the layer weights
            # (write + read) in fwd and bwd; full-EP expert weights are
            # resident and never gathered
            gatherable = w_compute if not run.moe_full_ep \
                else param_count(cfg, active=True) * pb / tp
            t += nmicro * 2 * 2 * gatherable
        stored = n_total * pb / (tp * (dp if run.fsdp else 1))
        mdt = _bytes_of(run.optimizer.moment_dtype)
        t += 2 * stored                            # p read+write
        t += 4 * (n_total * mdt / (tp * (dp if run.fsdp else 1)))  # m, v r+w
        t += (2 * nmicro + 1) * (n_total * 4 / (tp * (dp if run.fsdp else 1)))
        # activations: fwd + recompute + bwd = 3 pass-sets with remat
        pass_sets = 3 if run.remat != "none" else 2
        t += nmicro * pass_sets * ACT_RT * cfg.num_layers * b_mic * s * d * 2
        if not cfg.attention_free:
            restreams = max(s // FLASH_BQ, 1)
            kvb = b_mic * s * max(cfg.num_kv_heads, 1) \
                * cfg.resolved_head_dim * 2 * 2
            t += nmicro * pass_sets * cfg.num_layers * restreams * kvb / tp
        t += nmicro * 2 * b_mic * s * (vp / tp) * 4        # logits r/w
        return float(t)

    if shape.step == StepKind.PREFILL:
        t = w_compute
        if run.fsdp:
            t += 2 * w_compute
        t += ACT_RT * cfg.num_layers * b_loc * s * d * 2
        if not cfg.attention_free:
            restreams = max(s // FLASH_BQ, 1)
            kvb = b_loc * s * max(cfg.num_kv_heads, 1) \
                * cfg.resolved_head_dim * 2 * 2
            t += cfg.num_layers * restreams * kvb / tp
        return float(t)

    # decode: weights once + full cache read + tiny activations
    t = w_compute
    if run.fsdp:
        t += 2 * w_compute
    if cfg.mla is not None:
        cache = cfg.num_layers * shape.global_batch * s \
            * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
    elif cfg.attention_free:
        dh = cfg.rwkv_head_dim
        cache = cfg.num_layers * shape.global_batch \
            * (d // dh) * dh * dh * 2
    else:
        n_attn = sum(1 for m, _ in cfg.pattern if m == BK.ATTENTION) \
            * (cfg.num_layers // cfg.interleave_period)
        cache = n_attn * shape.global_batch * s * max(cfg.num_kv_heads, 1) \
            * cfg.resolved_head_dim * 2 * 2
        if cfg.mamba is not None:
            n_m = sum(1 for m, _ in cfg.pattern if m == BK.MAMBA) \
                * (cfg.num_layers // cfg.interleave_period)
            cache += n_m * shape.global_batch * cfg.mamba.expand * d \
                * cfg.mamba.d_state * 2
    t += cache / dev
    t += ACT_RT * cfg.num_layers * shape.global_batch * d * 2 / dev
    return float(t)
