"""Encoder-decoder transformer (whisper-medium backbone), as an
``nn.Module``.

Mirrors ``repro.models.encdec``. The conv/mel frontend is a stub, as in the
reference: ``batch["frames"]`` holds precomputed frame embeddings (B,
source_len, d_model). The encoder is bidirectional; a decoder layer is
self-attention (causal, cached), cross-attention (keys and values computed
once from the encoder's output) and a tanh-gelu FFN. LayerNorm and learned
positions, no rope. The JAX package stacks each stack's layers for a
``lax.scan``; here ``enc_layers`` and ``dec_layers`` are module lists and
``models/convert.py::encdec_params_from_jax`` splits the stacks.

On a CUDA card the encoder's self-attention and every cross-attention
(prefill and decode) run the flash kernel, non-causal, and the decoder's
prefill self-attention runs it causal: 2 x 24 + 24 launches a whisper
prefill and 24 a decode step. Decode self-attention attends the cache with
``kv_valid_len``, so it takes the plain decode path, as GQA decode does.
The cache is ``{"self": [(K, V)] per layer, each (B, max_len, H, dh),
"cross": [(K, V)] per layer, each (B, source_len, H, dh)}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import attention as attn
from repro_torch.models.attention import _proj
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    layer_norm,
    make_generator,
    pad_heads,
    padded_vocab,
    softmax_xent,
)
from repro_torch.models.transformer import Runtime, _auto_chunk, remat_call

KV = Tuple[torch.Tensor, torch.Tensor]


def _zeros(n: int, dt: torch.dtype, g: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dt, device=g.device))


class LayerNorm(nn.Module):
    """Weight ``w`` and bias ``b``, the JAX package's leaf names."""

    def __init__(self, d: int, dt: torch.dtype, g: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=dt, device=g.device))
        self.b = _zeros(d, dt, g)


def _ln(p: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p.w, p.b)


class FFN(nn.Module):
    """``wi`` (d, d_ff) with bias ``bi``, ``wo`` (d_ff, d) with ``bo``."""

    def __init__(self, cfg: ModelConfig, dt: torch.dtype,
                 g: torch.Generator):
        super().__init__()
        self.wi = nn.Parameter(dense_init((cfg.d_model, cfg.d_ff), g, dt))
        self.bi = _zeros(cfg.d_ff, dt, g)
        self.wo = nn.Parameter(dense_init((cfg.d_ff, cfg.d_model), g, dt))
        self.bo = _zeros(cfg.d_model, dt, g)


def _ffn(p: FFN, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.gelu(x @ p.wi.to(dt) + p.bi.to(dt), approximate="tanh")
    return h @ p.wo.to(dt) + p.bo.to(dt)


class MHA(nn.Module):
    """Multi-head attention weights without biases: wq, wk, wv (d, H*dh),
    wo (H*dh, d); H is the head count padded to the tensor-parallel
    degree."""

    def __init__(self, cfg: ModelConfig, dt: torch.dtype,
                 g: torch.Generator, tp: int = 1):
        super().__init__()
        d = cfg.d_model
        hd = pad_heads(cfg.num_heads, tp) * cfg.resolved_head_dim
        self.wq = nn.Parameter(dense_init((d, hd), g, dt))
        self.wk = nn.Parameter(dense_init((d, hd), g, dt))
        self.wv = nn.Parameter(dense_init((d, hd), g, dt))
        self.wo = nn.Parameter(dense_init((hd, d), g, dt))


def _mha(p: MHA, xq: torch.Tensor, xkv: Optional[torch.Tensor], *,
         causal: bool, chunk: int, dh: int, kv: Optional[KV] = None,
         cache: Optional[KV] = None, cache_index: Optional[int] = None,
         return_kv: bool = False, use_kernel: bool = True):
    """Self-attention over ``xkv`` (cached at decode: the new K/V written
    into ``cache`` in place), or cross-attention over precomputed ``kv``."""
    b, sq, _ = xq.shape
    hq = p.wq.shape[1] // dh
    q = _proj(xq, p.wq).reshape(b, sq, hq, dh)
    new_cache = None
    if kv is not None:                       # cross-attn with precomputed K/V
        k, v = kv
        out = attn.attention_core(q, k, v, causal=False, chunk=chunk,
                                  use_kernel=use_kernel)
    else:
        k = _proj(xkv, p.wk).reshape(b, -1, hq, dh)
        v = _proj(xkv, p.wv).reshape(b, -1, hq, dh)
        if cache is not None:
            ck, cv = attn.cache_step(cache, (k, v), cache_index)
            new_cache = cache
            valid = torch.full((b,), ck.shape[1], dtype=torch.long,
                               device=xq.device)
            out = attn.attention_core(q, ck, cv, causal=False,
                                      kv_valid_len=valid)
        else:
            out = attn.attention_core(q, k, v, causal=causal, chunk=chunk,
                                      use_kernel=use_kernel)
            if return_kv:
                new_cache = (k, v)
    y = _proj(out.reshape(b, sq, hq * dh), p.wo)
    return y, new_cache


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dt: torch.dtype,
                 g: torch.Generator, tp: int = 1):
        super().__init__()
        self.attn = MHA(cfg, dt, g, tp)
        self.attn_ln = LayerNorm(cfg.d_model, dt, g)
        self.ffn = FFN(cfg, dt, g)
        self.ffn_ln = LayerNorm(cfg.d_model, dt, g)


class DecLayer(nn.Module):
    """Self-attention (``self``, the JAX leaf's name), cross-attention and
    FFN, each with its pre-norm."""

    def __init__(self, cfg: ModelConfig, dt: torch.dtype,
                 g: torch.Generator, tp: int = 1):
        super().__init__()
        self.self = MHA(cfg, dt, g, tp)
        self.self_ln = LayerNorm(cfg.d_model, dt, g)
        self.cross = MHA(cfg, dt, g, tp)
        self.cross_ln = LayerNorm(cfg.d_model, dt, g)
        self.ffn = FFN(cfg, dt, g)
        self.ffn_ln = LayerNorm(cfg.d_model, dt, g)


class EncDecLM(nn.Module):
    """Whisper-style encoder-decoder; its entry points mirror
    ``TransformerLM``'s. Parameters are drawn from a ``torch.Generator``
    on ``device`` seeded with ``seed``; parity with the JAX package goes
    through converted parameters. ``use_kernel=False`` runs every
    attention on the plain path on a card too, to compare against."""

    def __init__(self, cfg: ModelConfig, rt: Optional[Runtime] = None, *,
                 device: torch.device, seed: int = 0):
        super().__init__()
        if device.type == "cuda":
            flash_kernel.build()
        rt = rt or Runtime()
        self.cfg, self.rt = cfg, rt
        self.vocab_p = padded_vocab(cfg.vocab_size)
        self.use_kernel = True
        g = make_generator(device, seed)
        dt, d = rt.param_dtype, cfg.d_model
        tp = rt.tp_degree
        self.enc_layers = nn.ModuleList(EncLayer(cfg, dt, g, tp)
                                        for _ in range(cfg.encoder.num_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dt, g, tp)
                                        for _ in range(cfg.num_layers))
        self.enc_pos = nn.Parameter(embed_init(
            (cfg.encoder.max_source_len, d), g, dt))
        self.dec_pos = nn.Parameter(embed_init((cfg.max_position, d), g, dt))
        self.embed = nn.Parameter(embed_init((self.vocab_p, d), g, dt))
        self.enc_ln = LayerNorm(d, dt, g)
        self.dec_ln = LayerNorm(d, dt, g)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- encoder ------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S, d_model) -> the encoder's output, same shape."""
        cfg, dt = self.cfg, self.rt.compute_dtype
        s = frames.shape[1]
        x = frames.to(dt) + self.enc_pos[:s].to(dt)
        chunk = _auto_chunk(self.rt, s)

        def layer(x, lp):
            h = _ln(lp.attn_ln, x)
            y, _ = _mha(lp.attn, h, h, causal=False, chunk=chunk,
                        dh=cfg.resolved_head_dim, use_kernel=self.use_kernel)
            x = x + y
            return x + _ffn(lp.ffn, _ln(lp.ffn_ln, x))

        for lp in self.enc_layers:
            x = remat_call(self.rt, layer, x, lp)
        return _ln(self.enc_ln, x)

    def _cross_kv(self, enc_out: torch.Tensor) -> List[KV]:
        dh = self.cfg.resolved_head_dim
        b, s, _ = enc_out.shape
        return [(_proj(enc_out, lp.cross.wk).reshape(b, s, -1, dh),
                 _proj(enc_out, lp.cross.wv).reshape(b, s, -1, dh))
                for lp in self.dec_layers]

    # -- decoder ------------------------------------------------------------
    def _decoder(self, x: torch.Tensor, cross_kv: List[KV], *,
                 caches: Optional[List[KV]] = None,
                 cache_index: Optional[int] = None,
                 return_caches: bool = False):
        dh = self.cfg.resolved_head_dim
        chunk = _auto_chunk(self.rt, x.shape[1])
        new_caches = []

        def layer(x, i):
            lp = self.dec_layers[i]
            h = _ln(lp.self_ln, x)
            y, nc = _mha(lp.self, h, h, causal=True, chunk=chunk,
                         dh=dh, cache=None if caches is None else caches[i],
                         cache_index=cache_index, return_kv=return_caches,
                         use_kernel=self.use_kernel)
            x = x + y
            h = _ln(lp.cross_ln, x)
            y, _ = _mha(lp.cross, h, None, causal=False, chunk=chunk, dh=dh,
                        kv=cross_kv[i], use_kernel=self.use_kernel)
            x = x + y
            return x + _ffn(lp.ffn, _ln(lp.ffn_ln, x)), nc

        for i in range(len(self.dec_layers)):
            if caches is None and not return_caches:
                x, nc = remat_call(self.rt, layer, x, i)
            else:
                x, nc = layer(x, i)
            new_caches.append(nc)
        return _ln(self.dec_ln, x), new_caches

    def _pos(self, start: int, n: int) -> torch.Tensor:
        # as the reference's dynamic_slice, a start past the table's end is
        # clamped so the slice fits
        start = max(0, min(int(start), self.dec_pos.shape[0] - n))
        return self.dec_pos[start:start + n]

    def _embed_tokens(self, tokens: torch.Tensor, pos0: int = 0
                      ) -> torch.Tensor:
        x = self.embed[tokens].to(self.rt.compute_dtype)
        return x + self._pos(pos0, tokens.shape[1]).to(x.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.embed.T.to(x.dtype)

    # -- public entry points ----------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean token cross-entropy of the decoder over ``batch["frames"]``
        and ``batch["tokens"]``; metrics ``{"xent"}``."""
        cross_kv = self._cross_kv(self.encode(batch["frames"]))
        x, _ = self._decoder(self._embed_tokens(batch["tokens"]), cross_kv)
        loss = softmax_xent(self._logits(x), batch["labels"],
                            self.cfg.vocab_size)
        return loss, {"xent": loss}

    def prefill(self, batch: Dict[str, torch.Tensor], pos0: int = 0):
        """Encode ``batch["frames"]`` and prefill the decoder with
        ``batch["tokens"]``; returns the last position's logits (B, 1, V)
        and ``{"self": [(K, V)] of the window, "cross": [(K, V)]}``."""
        cross_kv = self._cross_kv(self.encode(batch["frames"]))
        x = self._embed_tokens(batch["tokens"], pos0)
        x, self_kv = self._decoder(x, cross_kv, return_caches=True)
        return self._logits(x[:, -1:]), {"self": self_kv, "cross": cross_kv}

    def init_cache(self, batch: int, max_len: int,
                   prefix: Optional[Dict[str, List[KV]]] = None
                   ) -> Dict[str, List[KV]]:
        """Zeroed self-attention K/V (B, max_len) per layer and
        cross-attention K/V (B, source_len). With ``prefix`` (a prefill's
        caches) its self K/V are copied into the front and its cross K/V
        are taken as they are (decode never writes them)."""
        cfg, dt, dev = self.cfg, self.rt.compute_dtype, self.device
        h = pad_heads(cfg.num_heads, self.rt.tp_degree)
        dh = cfg.resolved_head_dim

        def pair(s):
            return tuple(torch.zeros((batch, s, h, dh), dtype=dt, device=dev)
                         for _ in range(2))

        caches = {"self": [pair(max_len) for _ in self.dec_layers]}
        if prefix is None:
            caches["cross"] = [pair(cfg.encoder.max_source_len)
                               for _ in self.dec_layers]
            return caches
        for dst, src in zip(caches["self"], prefix["self"]):
            for d, s in zip(dst, src):
                d[:, :s.shape[1]] = s.to(d.dtype)
        caches["cross"] = prefix["cross"]
        return caches

    def decode_step(self, caches: Dict[str, List[KV]], token: torch.Tensor,
                    cache_index: int):
        """token: (B, 1) int64; cache_index: the current length. Writes the
        new self K/V into ``caches`` in place and returns (logits (B, V),
        caches)."""
        cache_index = int(cache_index)
        x = self.embed[token].to(self.rt.compute_dtype)
        x = x + self._pos(cache_index, 1).to(x.dtype)[None]
        x, ncs = self._decoder(x, caches["cross"], caches=caches["self"],
                               cache_index=cache_index)
        return self._logits(x)[:, 0], {"self": ncs, "cross": caches["cross"]}
