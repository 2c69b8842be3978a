"""GNMT (paper §VI-B: LSTM encoder-decoder with attention) in PyTorch.

Mirrors ``repro.models.rnn``'s GNMT layer for layer. The LSTM weights are
stored in the fused cell's layout, ``w`` (D+H, H, 4) and ``b`` (H, 4), so the
recurrence runs the Hopper kernel on CUDA (``kernels/lstm_cell``) with no
per-step relayout; ``models/convert.py`` maps the JAX package's
(D+H, 4H) weights onto it. Per-iteration runtime is a function of the padded
SL because every layer steps through time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lstm_cell.ops import lstm_sequence
from repro_torch.models.layers import dense_init, embed_init, softmax_xent


class LSTM(nn.Module):
    """One LSTM layer: ``w`` (d_in+d_h, d_h, 4) with gates i|f|g|o on the
    last axis, one bias ``b`` (d_h, 4); the forget gate adds +1 inside the
    cell."""

    def __init__(self, d_in: int, d_h: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = nn.Parameter(dense_init((d_in + d_h, d_h, 4), generator,
                                         dtype))
        self.b = nn.Parameter(torch.zeros((d_h, 4), dtype=dtype,
                                          device=generator.device))

    def forward(self, xs: torch.Tensor, reverse: bool = False,
                use_kernel: bool = True) -> torch.Tensor:
        """xs: (B, S, d_in) -> (B, S, d_h), zero initial state."""
        h0 = xs.new_zeros((xs.shape[0], self.w.shape[1]))
        return lstm_sequence(xs, h0, h0, self.w, self.b, reverse=reverse,
                             use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# GNMT (paper §VI-B: 1 bi + 7 uni encoder LSTM, 8 decoder LSTM, attention,
# FC). ``num_enc_uni``/``num_dec`` shrink for small runs.


@dataclass(frozen=True)
class GNMTConfig:
    vocab_size: int = 32_000
    d_model: int = 1024
    num_enc_uni: int = 7
    num_dec: int = 8
    dtype: torch.dtype = torch.float32


class GNMT(nn.Module):
    """Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``. ``use_kernel=False`` runs the plain cell instead of the
    kernel, to compare the two on one device."""

    def __init__(self, cfg: GNMTConfig, *, seed: int = 0,
                 device: DeviceLike = "cuda", use_kernel: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_kernel = use_kernel
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        d, v, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
        self.src_embed = nn.Parameter(embed_init((v, d), g, dt))
        self.tgt_embed = nn.Parameter(embed_init((v, d), g, dt))
        self.enc_bi_f = LSTM(d, d // 2, g, dt)
        self.enc_bi_b = LSTM(d, d // 2, g, dt)
        self.enc_uni = nn.ModuleList(LSTM(d, d, g, dt)
                                     for _ in range(cfg.num_enc_uni))
        self.dec = nn.ModuleList(LSTM(d if i else 2 * d, d, g, dt)
                                 for i in range(cfg.num_dec))
        self.attn_q = nn.Parameter(dense_init((d, d), g, dt))
        self.out_proj = nn.Parameter(dense_init((2 * d, d), g, dt))
        self.head = nn.Parameter(dense_init((d, v), g, dt))

    @property
    def device(self) -> torch.device:
        return self.head.device

    def encode(self, src: torch.Tensor) -> torch.Tensor:
        k = self.use_kernel
        x = self.src_embed[src]
        x = torch.cat([self.enc_bi_f(x, use_kernel=k),
                       self.enc_bi_b(x, reverse=True, use_kernel=k)], dim=-1)
        for i, layer in enumerate(self.enc_uni):
            y = layer(x, use_kernel=k)
            x = x + y if i > 0 else y                      # residual stack
        return x

    def loss(self, batch: Dict[str, torch.Tensor]):
        c = self.cfg
        k = self.use_kernel
        src = batch["src"]
        enc = self.encode(src)                             # (B, Ss, d)
        x = self.tgt_embed[batch["tgt"]]                   # (B, St, d)
        # first decoder layer consumes [emb; attention context]
        q = self.dec[0](torch.cat([x, torch.zeros_like(x)], dim=-1),
                        use_kernel=k)
        scores = torch.einsum("btd,bsd->bts", q @ self.attn_q, enc)
        scores = scores.masked_fill((src <= 0)[:, None, :], -1e30)
        ctx = torch.einsum("bts,bsd->btd", torch.softmax(scores, -1), enc)
        h = torch.tanh(torch.cat([q, ctx], dim=-1) @ self.out_proj)
        for layer in self.dec[1:]:
            h = h + layer(h, use_kernel=k)
        logits = h @ self.head
        loss = softmax_xent(logits, batch["labels"], c.vocab_size)
        return loss, {"xent": loss}

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.loss(batch)[0]

    def make_batch(self, rng, batch_size: int, src_len: int, tgt_len: int):
        """The JAX package's batch for the same ``rng`` seed, on this
        model's device (token ids as int64 for indexing)."""
        r = np.random.RandomState(rng)
        v = self.cfg.vocab_size
        arrays = {
            "src": r.randint(1, v, size=(batch_size, src_len),
                             dtype=np.int32),
            "tgt": r.randint(1, v, size=(batch_size, tgt_len),
                             dtype=np.int32),
            "labels": r.randint(0, v, size=(batch_size, tgt_len),
                                dtype=np.int32),
        }
        return {k: torch.as_tensor(a, dtype=torch.long, device=self.device)
                for k, a in arrays.items()}
