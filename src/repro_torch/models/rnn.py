"""The paper's SQNNs in PyTorch: GNMT (LSTM encoder-decoder with attention)
and DeepSpeech2 (convolutions, bi-GRU, CTC) (paper §VI-B).

Mirrors ``repro.models.rnn`` layer for layer. GNMT's LSTM weights are
stored in the fused cell's layout, ``w`` (D+H, H, 4) and ``b`` (H, 4), so the
recurrence runs the Hopper kernel on CUDA (``kernels/lstm_cell``) with no
per-step relayout; ``models/convert.py`` maps the JAX package's
(D+H, 4H) weights onto it. Per-iteration runtime is a function of the padded
SL because every layer steps through time. DS2 has no kernel of its own:
its GRU, convolutions, batch-norm and CTC are PyTorch ops on any device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
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


class GRU(nn.Module):
    """One GRU layer in the JAX package's layout: ``wzr`` (d_in+d_h, 2 d_h)
    for the update|reset gates with their bias ``b`` (2 d_h,), ``wx``
    (d_in, d_h) and ``wh`` (d_h, d_h) for the candidate. The reset gate
    applies before the matmul, ``n = tanh(x Wx + (r*h) Wh)``, where
    ``torch.nn.GRU`` computes ``r * (h Wh + b)``; so the cell is written
    out here."""

    def __init__(self, d_in: int, d_h: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.wzr = nn.Parameter(dense_init((d_in + d_h, 2 * d_h), generator,
                                           dtype))
        self.wx = nn.Parameter(dense_init((d_in, d_h), generator, dtype))
        self.wh = nn.Parameter(dense_init((d_h, d_h), generator, dtype))
        self.b = nn.Parameter(torch.zeros((2 * d_h,), dtype=dtype,
                                          device=generator.device))

    def step(self, h: torch.Tensor, xzr: torch.Tensor, xn: torch.Tensor,
             wzr_h: torch.Tensor) -> torch.Tensor:
        """One timestep from the input's shares ``xzr = x Wzr_x + b`` and
        ``xn = x Wx``; ``wzr_h`` is the hidden rows of ``wzr``."""
        z, r = torch.sigmoid(torch.addmm(xzr, h, wzr_h)).chunk(2, dim=-1)
        n = torch.tanh(torch.addmm(xn, r * h, self.wh))
        return torch.lerp(n, h, z)                 # (1 - z) n + z h

    def forward(self, xs: torch.Tensor, reverse: bool = False
                ) -> torch.Tensor:
        """xs: (B, S, d_in) -> (B, S, d_h), zero initial state; with
        ``reverse`` the scan runs t = S-1 ... 0 and keeps each output at
        its own time index. The input's shares of every timestep are one
        GEMM before the loop (the same sums as the JAX package's
        ``[x; h] Wzr``, in another order), so a timestep is two GEMMs and
        four elementwise ops."""
        d_in, d_h = self.wx.shape
        proj = xs.transpose(0, 1) @ torch.cat([self.wzr[:d_in], self.wx],
                                              dim=1)   # (S, B, 3 d_h)
        # unbind, not an index per step: the gradients of S indexings are
        # S zero-filled full-size tensors summed, that of one unbind a stack
        xzr = (proj[..., :2 * d_h] + self.b).unbind(0)
        xn = proj[..., 2 * d_h:].unbind(0)
        wzr_h = self.wzr[d_in:]
        s = xs.shape[1]
        h = xs.new_zeros((xs.shape[0], d_h))
        hs = [None] * s
        for t in (range(s - 1, -1, -1) if reverse else range(s)):
            h = self.step(h, xzr[t], xn[t], wzr_h)
            hs[t] = h
        return torch.stack(hs, dim=1)


def gru_cell(p: GRU, h: torch.Tensor, x: torch.Tensor):
    """One timestep as ``repro.models.rnn.gru_cell``: (h, x) -> (h', h')."""
    d_in = p.wx.shape[0]
    h = p.step(h, torch.addmm(p.b, x, p.wzr[:d_in]), x @ p.wx,
               p.wzr[d_in:])
    return h, h


class BiGRU(nn.Module):
    """``repro.models.rnn.bidir`` over a GRU pair: forward and reversed
    outputs concatenated, (B, S, d_in) -> (B, S, 2 d_h)."""

    def __init__(self, d_in: int, d_h: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fwd = GRU(d_in, d_h, generator, dtype)
        self.bwd = GRU(d_in, d_h, generator, dtype)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.fwd(xs), self.bwd(xs, reverse=True)], dim=-1)


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

    def encode(self, src: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        k = use_kernel
        x = self.src_embed[src]
        x = torch.cat([self.enc_bi_f(x, use_kernel=k),
                       self.enc_bi_b(x, reverse=True, use_kernel=k)], dim=-1)
        for i, layer in enumerate(self.enc_uni):
            y = layer(x, use_kernel=k)
            x = x + y if i > 0 else y                      # residual stack
        return x

    def loss(self, batch: Dict[str, torch.Tensor],
             use_kernel: Optional[bool] = None):
        """``use_kernel`` overrides the model's choice for this call."""
        c = self.cfg
        k = self.use_kernel if use_kernel is None else use_kernel
        src = batch["src"]
        enc = self.encode(src, k)                          # (B, Ss, d)
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


# ---------------------------------------------------------------------------
# DeepSpeech2 (paper §VI-B: 2 conv, 5 bi-GRU, 1 FC, batch-norm, CTC)


@dataclass(frozen=True)
class DS2Config:
    num_freq: int = 161
    conv_channels: int = 32
    d_h: int = 800
    num_gru: int = 5
    vocab_size: int = 29                                   # chars + blank
    dtype: torch.dtype = torch.float32


CONV1_KERNEL = (11, 41)                                    # (time, freq)
CONV2_KERNEL = (11, 21)


def same_out(n: int) -> int:
    """Output length of a stride-2 ``"SAME"`` convolution: ceil(n / 2)."""
    return -(-n // 2)


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """XLA's ``"SAME"`` cross-correlation at stride 2, NCHW input and
    (C_out, C_in, kT, kF) weight. torch rejects ``padding="same"`` at a
    stride above 1, so each axis is padded explicitly as XLA does: ``total
    = max((ceil(n/2) - 1) * 2 + k - n, 0)``, ``total // 2`` before."""
    pads = []
    for n, k in zip(reversed(x.shape[2:]), reversed(w.shape[2:])):
        total = max((same_out(n) - 1) * 2 + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=2)


class DS2(nn.Module):
    """Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``; ``models/convert.py`` maps the JAX package's parameters
    onto them."""

    def __init__(self, cfg: DS2Config, *, seed: int = 0,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        ch, d_h, dt = cfg.conv_channels, cfg.d_h, cfg.dtype
        # The first GRU reads what the two stride-2 SAME convolutions leave
        # of the frequency axis: ceil(ceil(F/2)/2) bins of ``ch`` channels.
        # repro.models.rnn.DS2 sizes it as num_freq // 4, one bin short when
        # num_freq % 4 != 0, so the reference's loss fails a shape check at
        # the paper's 161 bins (41 here, 40 there); where num_freq % 4 == 0
        # the two agree.
        f_out = same_out(same_out(cfg.num_freq)) * ch
        self.conv1 = nn.Parameter(dense_init((ch, 1, *CONV1_KERNEL), g, dt,
                                             scale=0.05))
        self.conv2 = nn.Parameter(dense_init((ch, ch, *CONV2_KERNEL), g, dt,
                                             scale=0.05))
        self.bn_scale = nn.Parameter(torch.ones((ch,), dtype=dt,
                                                device=g.device))
        self.bn_bias = nn.Parameter(torch.zeros((ch,), dtype=dt,
                                                device=g.device))
        self.gru = nn.ModuleList(BiGRU(f_out if i == 0 else 2 * d_h, d_h, g,
                                       dt) for i in range(cfg.num_gru))
        self.head = nn.Parameter(dense_init((2 * d_h, cfg.vocab_size), g,
                                            dt))

    @property
    def device(self) -> torch.device:
        return self.head.device

    def frontend(self, spec: torch.Tensor) -> torch.Tensor:
        """spec: (B, T, F) -> (B, ceil(ceil(T/2)/2), F' * C), F' likewise,
        flattened F-major as the JAX package does."""
        x = F.relu(conv2d_same(spec[:, None], self.conv1))
        x = conv2d_same(x, self.conv2)
        # batch-norm over (B, T, F) per channel: batch statistics, biased
        # variance, no running statistics
        var, mu = torch.var_mean(x, dim=(0, 2, 3), correction=0,
                                 keepdim=True)
        x = (x - mu) * torch.rsqrt(var + 1e-5)
        x = F.relu(x * self.bn_scale[None, :, None, None]
                   + self.bn_bias[None, :, None, None])
        b, ch, t, f = x.shape
        return x.permute(0, 2, 3, 1).reshape(b, t, f * ch)

    def logits(self, spec: torch.Tensor) -> torch.Tensor:
        x = self.frontend(spec)
        for layer in self.gru:
            x = layer(x)
        return x @ self.head

    def loss(self, batch: Dict[str, torch.Tensor]):
        loss = ctc_loss(self.logits(batch["spec"]), batch["labels"],
                        batch["label_lens"])
        return loss, {"ctc": loss}

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.loss(batch)[0]

    def make_batch(self, rng, batch_size: int, num_frames: int,
                   label_len: int = 0):
        """The JAX package's batch for the same ``rng`` seed, on this
        model's device (labels and their lengths as int64)."""
        r = np.random.RandomState(rng)
        c = self.cfg
        label_len = label_len or max(2, num_frames // 32)
        spec = r.randn(batch_size, num_frames, c.num_freq).astype(np.float32)
        labels = r.randint(1, c.vocab_size, size=(batch_size, label_len),
                           dtype=np.int32)
        dev = self.device
        return {"spec": torch.as_tensor(spec, device=dev),
                "labels": torch.as_tensor(labels, dtype=torch.long,
                                          device=dev),
                "label_lens": torch.full((batch_size,), label_len,
                                         dtype=torch.long, device=dev)}


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_lens: torch.Tensor) -> torch.Tensor:
    """logits: (B, T, V); labels: (B, L), blank and pad 0. The batch mean of
    -log p(labels), not divided by the label length, every input T frames
    long, as ``repro.models.rnn.ctc_loss``. The labels go in as int64 on the
    logits' device, so PyTorch's own CTC runs (its cuDNN path takes int32
    labels on the CPU and has its own gradient convention). CTC has no
    Pallas kernel in the JAX package; the library call is the port."""
    b, t, _ = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    frames = torch.full((b,), t, dtype=torch.long, device=logits.device)
    return F.ctc_loss(logp, labels.long(), frames, label_lens.long(),
                      blank=0, reduction="none").mean()
