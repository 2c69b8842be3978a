"""Plain PyTorch version of the flash attention forward, folded layout."""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (BH, Sq, dh); k/v: (BHkv, Skv, dh). GQA by head repetition; the
    causal mask is aligned top-left (key j attends query i iff j <= i).
    Computes in float32 (float64 stays float64). Returns the output in q's
    type and each row's log-sum-exp of its scaled scores, (BH, Sq) in the
    compute type: what the forward kernel writes beside o."""
    bh, sq, dh = q.shape
    bhkv, skv, _ = k.shape
    if bhkv != bh:
        k = k.repeat_interleave(bh // bhkv, dim=0)
        v = v.repeat_interleave(bh // bhkv, dim=0)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) / math.sqrt(dh)
    if causal:
        mask = torch.arange(skv, device=q.device)[None, :] \
            <= torch.arange(sq, device=q.device)[:, None]
        s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.to(acc)).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """``attention_ref_lse``'s output alone."""
    return attention_ref_lse(q, k, v, causal)[0]
