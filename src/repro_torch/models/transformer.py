"""Decoder-only LM over a configurable block pattern, as an ``nn.Module``.

Mirrors ``repro.models.transformer``. The JAX stack is a ``lax.scan`` over
super-layers with parameters stacked on a leading ``n_periods`` axis; here
each layer is its own module in ``layers`` (layer ``i`` is period
``i // len(pattern)``, pattern entry ``i % len(pattern)``) and the scan is a
loop. ``models/convert.py`` maps the stacked JAX tree onto it.

Mixers: GQA attention, MLA, Mamba and RWKV-6 time-mix; FFNs: gated dense,
single-device MoE and RWKV-6 channel-mix. A config with ``mtp_depth`` gets
the multi-token-prediction head (``mtp``), which only ``loss`` runs; one
with the ``image_patches`` frontend takes ``batch["patches"]`` (B, P,
d_model) in front of the token embeddings. The cache is a list with one
entry per layer: an attention layer's ``(K, V)`` pair, each ``(B, S, Hkv,
dh)``, an MLA layer's latent pair ``(c_kv (B, S, kv_lora_rank), k_rope
(B, S, qk_rope_head_dim))``, a mamba layer's ``{"mixer": {"conv", "ssm"},
"ffn": {}}`` or an rwkv layer's ``{"mixer": {"shift", "state"}, "ffn":
{"shift"}}``; ``decode_step`` writes into each in place. A model placed on
a CUDA card builds the kernels its pattern runs (flash attention, the
selective scan, WKV6), so compile time never lands in a timed prefill.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import BlockKind as BK
from repro_torch.configs.base import (
    ModelConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
)
from repro_torch.dist import regions
from repro_torch.dist.axes import constrain
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.mamba_scan import kernel as mamba_kernel
from repro_torch.kernels.rwkv6_wkv import kernel as wkv6_kernel
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rw
from repro_torch.models.layers import (
    act_fn,
    dense_init,
    embed_init,
    embed_lookup,
    make_generator,
    pad_heads,
    padded_vocab,
    rms_norm,
    softmax_xent,
)

LayerCache = Union[Tuple[torch.Tensor, torch.Tensor],
                   Dict[str, Dict[str, torch.Tensor]]]
Cache = List[LayerCache]
# an input's (shape, dtype), the reference's ``jax.ShapeDtypeStruct``
InputSpec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs the model code sees, resolved from a ``RunConfig``
    and its mesh (the model never sees the mesh itself).

    ``tp_degree`` pads head counts up to a multiple of it (``pad_heads``),
    so a model built for a tensor-parallel mesh has the same parameter
    shapes as the reference's. ``attn_chunk`` fixes the plain attention
    path's KV chunk (0 = automatic: ``AUTO_CHUNK`` from
    ``AUTO_CHUNK_THRESHOLD`` tokens on); on a card every attention without
    a cache still runs the flash kernel. ``remat`` is ``"none"``,
    ``"block"`` (each interleave period, the MTP block and every
    encoder-decoder layer recompute their forward in the backward) or
    ``"save_boundaries"`` (each period recomputes all but the mixer's and
    the FFN's outputs, the tensors the reference names
    ``block_boundary``); any other value, as in the reference, saves
    everything. ``moe_full_ep`` takes the all-to-all expert path
    under a mesh with a model axis."""

    tp_degree: int = 1
    attn_chunk: int = 0          # 0 = auto
    remat: str = "none"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    moe_full_ep: bool = False

    @staticmethod
    def from_run(run: RunConfig) -> "Runtime":
        """Maps the run's knobs as the reference's ``Runtime.from_run``
        does. The reference's ``unroll_layers`` and ``attn_unroll`` only
        change how XLA compiles a ``lax.scan`` (unrolled or rolled, the
        same numbers); the port's layer loop and KV-chunk loop are eager
        Python loops with nothing to unroll, so they have no field here."""
        tp = run.mesh.model_degree if run.parallelism == "tp" else 1
        return Runtime(tp_degree=tp, attn_chunk=run.attn_chunk,
                       remat=run.remat,
                       param_dtype=getattr(torch, run.param_dtype),
                       compute_dtype=getattr(torch, run.compute_dtype),
                       moe_full_ep=run.moe_full_ep)


# serving on the card: bf16 parameters and compute, the reference
# RunConfig's defaults
BF16 = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)

AUTO_CHUNK_THRESHOLD = 8192
AUTO_CHUNK = 2048
MTP_LOSS_WEIGHT = 0.3
VLM_NUM_PATCHES = 2880           # anyres: 5 tiles x 576 patch tokens
# the pair-shaped caches: K/V, or MLA's latents
_PAIR_CACHE = (BK.ATTENTION, BK.MLA)


def _boundary(rt: Runtime, t: torch.Tensor) -> torch.Tensor:
    """Marks a block boundary (the reference's ``checkpoint_name(t,
    "block_boundary")``): under ``remat="save_boundaries"`` an
    ``aten.alias`` of ``t``, the one op the selective-checkpoint policy
    saves; otherwise ``t`` itself."""
    if rt.remat == "save_boundaries":
        return torch.ops.aten.alias.default(t)
    return t


def _save_boundaries(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    if func is torch.ops.aten.alias.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(rt: Runtime, fn, *args, boundaries: bool = False):
    """``fn(*args)``, rematerialized as ``rt.remat`` asks when autograd
    records: ``"block"`` saves only the inputs
    (``torch.utils.checkpoint.checkpoint``, non-reentrant); with
    ``boundaries`` (a super-layer) ``"save_boundaries"`` also saves what
    ``_boundary`` marked, through a selective-checkpoint policy, and
    recomputes the rest. The reference applies ``"save_boundaries"`` to the
    super-layer only, so elsewhere it saves everything, as here."""
    if not torch.is_grad_enabled() or rt.remat not in (
            "block", "save_boundaries"):
        return fn(*args)
    if rt.remat == "block":
        return checkpoint(fn, *args, use_reentrant=False)
    if not boundaries:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _save_boundaries))


def _auto_chunk(rt: Runtime, seq: int) -> int:
    if rt.attn_chunk:
        return rt.attn_chunk
    if seq >= AUTO_CHUNK_THRESHOLD:
        return AUTO_CHUNK
    return 0


# ---------------------------------------------------------------------------
# blocks


class FFN(nn.Module):
    """Gated FFN: ``wi`` (d, 2*d_ff) gives gate and up halves, ``wo``
    (d_ff, d)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        self.wi = nn.Parameter(dense_init((cfg.d_model, 2 * cfg.d_ff),
                                          generator, dtype))
        self.wo = nn.Parameter(dense_init((cfg.d_ff, cfg.d_model),
                                          generator, dtype))


def ffn_forward(p: FFN, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g, u = (x @ p.wi.to(x.dtype)).chunk(2, dim=-1)
    return (act_fn(cfg.act)(g) * u) @ p.wo.to(x.dtype)


class Block(nn.Module):
    """One residual block: pre-norm mixer (GQA attention, MLA, Mamba or
    RWKV time-mix), then pre-norm FFN (gated dense, MoE or RWKV
    channel-mix)."""

    def __init__(self, cfg: ModelConfig, kinds: Tuple[BK, BK], rt: Runtime,
                 generator: torch.Generator):
        super().__init__()
        dt, dev = rt.param_dtype, generator.device
        self.kinds = kinds
        self.tp = rt.tp_degree
        self.mixer_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                                  device=dev))
        self.ffn_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                                device=dev))
        if kinds[0] == BK.ATTENTION:
            self.mixer = attn.init_gqa(cfg, pad_heads(cfg.num_heads, self.tp),
                                       generator, dt)
        elif kinds[0] == BK.MLA:
            self.mixer = attn.init_mla(cfg, generator, dt)
        elif kinds[0] == BK.MAMBA:
            self.mixer = mb.Mamba(cfg, generator, dt)
        else:
            self.mixer = rw.TimeMix(cfg, generator, dt, self.tp)
        if kinds[1] == BK.DENSE_FFN:
            self.ffn = FFN(cfg, generator, dt)
        elif kinds[1] == BK.MOE_FFN:
            self.ffn = moe_mod.MoE(cfg, generator, dt)
        else:
            self.ffn = rw.ChannelMix(cfg, generator, dt)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device) -> LayerCache:
        if self.kinds[0] == BK.ATTENTION:
            shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            return tuple(torch.zeros(shape, dtype=dtype, device=device)
                         for _ in range(2))
        if self.kinds[0] == BK.MLA:
            m = cfg.mla
            return tuple(torch.zeros((batch, max_len, n), dtype=dtype,
                                     device=device)
                         for n in (m.kv_lora_rank, m.qk_rope_head_dim))
        if self.kinds[0] == BK.MAMBA:
            return {"mixer": mb.init_mamba_cache(cfg, batch, dtype, device),
                    "ffn": {}}
        return {"mixer": rw.init_time_mix_cache(cfg, batch, dtype, device,
                                                self.tp),
                "ffn": rw.init_channel_mix_cache(cfg, batch, dtype, device)}


def block_forward(p: Block, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                  *, positions: torch.Tensor,
                  cache: Optional[LayerCache] = None,
                  cache_index: Optional[int] = None,
                  return_cache: bool = False, use_kernel: bool = True):
    """Returns (x, the layer's cache or None, the MoE aux loss or None)."""
    mixer, ffn = p.kinds
    h = regions.grad_layout(rms_norm(x, p.mixer_norm, cfg.norm_eps))
    if mixer == BK.ATTENTION:
        y, c = attn.gqa_forward(p.mixer, h, cfg, positions=positions,
                                chunk=_auto_chunk(rt, x.shape[1]),
                                cache=cache, cache_index=cache_index,
                                return_kv=return_cache,
                                use_kernel=use_kernel)
    elif mixer == BK.MLA:
        y, c = attn.mla_forward(p.mixer, h, cfg, positions=positions,
                                chunk=_auto_chunk(rt, x.shape[1]),
                                cache=cache, cache_index=cache_index,
                                return_kv=return_cache,
                                use_kernel=use_kernel)
    elif mixer == BK.MAMBA:
        y, c = mb.mamba_forward(
            p.mixer, h, cfg, cache=None if cache is None else cache["mixer"],
            return_state=return_cache, use_kernel=use_kernel)
    else:
        y, c = rw.time_mix_forward(
            p.mixer, h, cfg, cache=None if cache is None else cache["mixer"],
            return_state=return_cache, use_kernel=use_kernel)
    x = x + _boundary(rt, regions.reduce_out(y))
    h = regions.grad_layout(rms_norm(x, p.ffn_norm, cfg.norm_eps))
    aux, c2 = None, {}
    if ffn == BK.DENSE_FFN:
        y = ffn_forward(p.ffn, h, cfg)
    elif ffn == BK.MOE_FFN:
        y, aux = moe_mod.moe_forward(p.ffn, h, cfg, rt.moe_full_ep)
    else:
        y, c2 = rw.channel_mix_forward(
            p.ffn, h, cfg, cache=None if cache is None else cache["ffn"],
            return_state=return_cache)
    if mixer not in _PAIR_CACHE and c is not None:
        c = {"mixer": c, "ffn": c2}
    return x + _boundary(rt, regions.reduce_out(y)), c, aux


class MTP(nn.Module):
    """DeepSeek-V3-style multi-token-prediction head: one more block of
    the pattern's first kind over ``proj`` of [norm_h(h_t) ;
    norm_e(emb(token_{t+1}))], predicting token t+2."""

    def __init__(self, cfg: ModelConfig, rt: Runtime,
                 generator: torch.Generator):
        super().__init__()
        dt, dev = rt.param_dtype, generator.device
        self.proj = nn.Parameter(dense_init((2 * cfg.d_model, cfg.d_model),
                                            generator, dt))
        self.block = Block(cfg, cfg.pattern[0], rt, generator)
        self.norm_h = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                              device=dev))
        self.norm_e = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                              device=dev))


# ---------------------------------------------------------------------------
# the model


class TransformerLM(nn.Module):
    """Decoder-only LM. Parameters are drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``; they follow the JAX init's
    distributions but not its numbers, so parity goes through converted
    parameters. ``use_kernel=False`` runs prefill attention, every
    selective scan and every WKV on the plain path on a card too, to
    compare against."""

    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None, *,
                 device: torch.device, seed: int = 0):
        super().__init__()
        if device.type == "cuda":
            kinds = {kind for pair in cfg.pattern for kind in pair}
            if kinds & set(_PAIR_CACHE):
                flash_kernel.build()
            if BK.MAMBA in kinds:
                mamba_kernel.build()
            if BK.RWKV in kinds:
                wkv6_kernel.build()
        rt = rt or Runtime()
        self.cfg = cfg
        self.rt = rt
        self.vocab_p = padded_vocab(cfg.vocab_size)
        self.use_kernel = True
        g = make_generator(device, seed)
        dt = rt.param_dtype
        self.embed = nn.Parameter(embed_init((self.vocab_p, cfg.d_model), g,
                                             dt))
        period = len(cfg.pattern)
        self.layers = nn.ModuleList(Block(cfg, cfg.pattern[i % period], rt, g)
                                    for i in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                                  device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(
                (cfg.d_model, self.vocab_p), g, dt))
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, rt, g)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- helpers ----------------------------------------------------------
    def _patches(self, batch: Dict[str, torch.Tensor]) -> bool:
        return self.cfg.frontend == "image_patches" and "patches" in batch

    def _embed(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = embed_lookup(self.embed, batch["tokens"]).to(
            self.rt.compute_dtype)
        x = constrain(x, "dp", None, None)
        if self._patches(batch):
            x = torch.cat([batch["patches"].to(self.rt.compute_dtype), x],
                          dim=1)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = regions.grad_layout(rms_norm(x, self.final_norm,
                                         self.cfg.norm_eps))
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return constrain(x @ w.to(x.dtype), "dp", None, "tp")

    def _stack(self, x: torch.Tensor, positions: torch.Tensor, *,
               caches: Optional[Cache] = None,
               cache_index: Optional[int] = None,
               return_caches: bool = False):
        """Returns (x, the per-layer caches, the sum of the MoE layers' aux
        losses: a tensor, or 0.0 when no layer is MoE). Without caches
        each interleave period (the reference's ``super_layer``) runs
        through ``remat_call``."""
        period = len(self.cfg.pattern)
        new_caches: Cache = []

        def super_layer(x, aux, lo):
            out = []
            for i in range(lo, lo + period):
                x, c, a = block_forward(
                    self.layers[i], x, self.cfg, self.rt,
                    positions=positions,
                    cache=None if caches is None else caches[i],
                    cache_index=cache_index, return_cache=return_caches,
                    use_kernel=self.use_kernel)
                out.append(c)
                if a is not None:
                    aux = aux + a
            return x, aux, out

        aux = 0.0
        for lo in range(0, len(self.layers), period):
            if caches is None and not return_caches:
                x, aux, out = remat_call(self.rt, super_layer, x, aux, lo,
                                         boundaries=True)
            else:
                x, aux, out = super_layer(x, aux, lo)
            new_caches.extend(out)
        return x, new_caches, aux

    # -- public entry points ----------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean token cross-entropy of a forward pass, plus
        ``MTP_LOSS_WEIGHT`` x the MTP head's where the model has one, plus
        the MoE layers' load-balance loss; metrics ``{"xent", "aux"}`` and
        ``"mtp"``. Image-patch positions carry no LM loss."""
        cfg = self.cfg
        x = self._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = self._stack(x, positions)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        labels = batch["labels"]
        if self._patches(batch):
            pad = labels.new_full(batch["patches"].shape[:2], -1)
            labels = torch.cat([pad, labels], dim=1)
        xent = softmax_xent(self._head(x), labels, cfg.vocab_size)
        metrics = {"xent": xent, "aux": aux}
        loss = xent
        if cfg.mtp_depth:
            metrics["mtp"] = self._mtp_loss(x, batch)
            loss = loss + MTP_LOSS_WEIGHT * metrics["mtp"]
        return loss + aux, metrics

    def _mtp_loss(self, h: torch.Tensor, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        """DeepSeek-V3-style multi-token prediction: one extra block
        predicts token t+2 from [h_t ; emb(token_{t+1})]."""
        cfg, mtp = self.cfg, self.mtp
        tokens, labels = batch["tokens"], batch["labels"]
        # tokens rolled one to the left, by cat (DTensor has no rule for
        # roll)
        nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        emb_next = constrain(embed_lookup(self.embed, nxt).to(h.dtype),
                             "dp", None, None)
        feat = torch.cat([rms_norm(h, mtp.norm_h, cfg.norm_eps),
                          rms_norm(emb_next, mtp.norm_e, cfg.norm_eps)],
                         dim=-1)
        if self._patches(batch):
            feat = feat[:, batch["patches"].shape[1]:]
        # the projection's gradient is a partial sum over "model"; the
        # embedding's lookup (a masked partial) cannot take one back
        x = regions.grad_layout(feat) @ mtp.proj.to(feat.dtype)

        def mtp_block(xx):
            return block_forward(mtp.block, xx, cfg, self.rt,
                                 positions=torch.arange(xx.shape[1],
                                                        device=xx.device),
                                 use_kernel=self.use_kernel)[0]

        x = remat_call(self.rt, mtp_block, x)
        labels2 = torch.cat([labels[:, 1:], labels.new_full(
            labels[:, :1].shape, -1)], dim=1)
        return softmax_xent(self._head(x), labels2, cfg.vocab_size)

    def prefill(self, batch: Dict[str, torch.Tensor], pos0: int = 0):
        """Prefill a prompt. ``pos0`` offsets the rope positions so a prompt
        can be placed at an absolute cache offset (continuous-batching slot
        admission); the causal mask is local to the window either way.
        Returns the last position's logits (B, 1, V) and the per-layer
        cache of the window: (K, V), MLA's (c_kv, k_rope), or a mamba or
        rwkv layer's recurrent states after its last position. Image
        patches, where given, take the window's first positions."""
        x = self._embed(batch)
        positions = int(pos0) + torch.arange(x.shape[1], device=x.device)
        x, caches, _ = self._stack(x, positions, return_caches=True)
        return self._head(x[:, -1:]), caches

    def init_cache(self, batch: int, max_len: int,
                   prefix: Optional[Cache] = None) -> Cache:
        """A zeroed cache per layer, (B, max_len) for K/V and MLA's
        latents; with ``prefix``, a prefill's per-layer pairs are copied
        into its front and its recurrent leaves (conv and ssm, shift and
        state) are copied whole."""
        caches = [layer.init_cache(self.cfg, batch, max_len,
                                   self.rt.compute_dtype, self.device)
                  for layer in self.layers]
        for dst, src in zip(caches, prefix or ()):
            if isinstance(dst, dict):
                for part, leaves in dst.items():
                    for name, d in leaves.items():
                        d.copy_(src[part][name])
            else:
                for d, s in zip(dst, src):
                    d[:, :s.shape[1]] = s.to(d.dtype)
        return caches

    def decode_step(self, caches: Cache, token: torch.Tensor,
                    cache_index: int):
        """token: (B, 1) int64; cache_index: the current length, shared by
        every row. Writes the new K/V (or shift and state) into ``caches``
        in place and returns (logits (B, V), caches)."""
        cache_index = int(cache_index)
        x = embed_lookup(self.embed, token).to(self.rt.compute_dtype)
        x = constrain(x, "dp", None, None)
        positions = torch.tensor([cache_index], device=x.device)
        x, new_caches, _ = self._stack(x, positions, caches=caches,
                                       cache_index=cache_index)
        return self._head(x)[:, 0], new_caches

    # -- specs --------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, InputSpec]:
        """The step's inputs as ``{name: (shape, dtype)}``, the reference's
        ``ShapeDtypeStruct``s: tokens and labels (B, S) int32 for train and
        prefill (an image-patch model takes ``min(VLM_NUM_PATCHES, S // 2)``
        patch embeddings in front of S minus that many tokens); one token
        (B, 1) and a scalar ``cache_index`` for decode."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.step in (StepKind.TRAIN, StepKind.PREFILL):
            n_img = min(VLM_NUM_PATCHES, s // 2) \
                if cfg.frontend == "image_patches" else 0
            specs = {"tokens": ((b, s - n_img), i32)}
            if n_img:
                specs["patches"] = ((b, n_img, cfg.d_model),
                                    self.rt.compute_dtype)
            if shape.step == StepKind.TRAIN:
                specs["labels"] = ((b, s - n_img), i32)
            return specs
        return decode_specs(b)


def decode_specs(batch: int) -> Dict[str, InputSpec]:
    """A decode step's inputs: one token a row and the cache length."""
    return {"token": ((batch, 1), torch.int32),
            "cache_index": ((), torch.int32)}
