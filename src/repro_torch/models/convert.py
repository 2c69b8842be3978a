"""Convert JAX parameter trees into the port's state dicts.

GNMT (``gnmt_params_from_jax``): the JAX model keeps each LSTM's weight as
(D+H, 4H) with gate blocks i|f|g|o along the columns and its bias as (4H,).
The port keeps the fused cell's layout, (D+H, H, 4) and (H, 4), so each
hidden unit's four gates sit together. The adapter is a reshape and a
transpose, exact to the bit.

DS2 (``ds2_params_from_jax``): the GRU weights keep the JAX layout, so
they are copies; the convolution kernels go from (kT, kF, C_in, C_out) to
torch's (C_out, C_in, kT, kF), a transpose, exact to the bit.

The decoder-only LM (``transformer_params_from_jax``): the JAX tree stacks
each pattern entry's leaves on a leading ``n_periods`` axis for its
``lax.scan``; the port has one module per layer, so the stack is split,
layer ``i`` taking period ``i // period`` of pattern entry ``i % period``.
Nested subtrees outside the stack (the MTP head's ``mtp``) are flattened
to dotted names. The encoder-decoder (``encdec_params_from_jax``) stacks
``enc_layers`` and ``dec_layers`` on a leading layer axis; each is split
into one module per layer.

Trees hold numpy arrays (``jax.tree.map(np.asarray, params)``); this module
imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy has no native bf16
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def transformer_params_from_jax(tree: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """``repro.models.transformer.TransformerLM`` params (numpy leaves) ->
    state dict for ``repro_torch.models.transformer.TransformerLM`` with
    the same config."""
    rest = {k: v for k, v in tree.items() if k != "layers"}
    sd = {k: _tensor(v) for k, v in _flatten(rest, "").items()}
    period = len(tree["layers"])
    for j, entry in enumerate(tree["layers"]):
        for path, leaf in _flatten(entry, "").items():
            for n in range(np.shape(leaf)[0]):
                sd[f"layers.{n * period + j}.{path}"] = _tensor(leaf[n])
    return sd


def encdec_params_from_jax(tree: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """``repro.models.encdec.EncDecLM`` params (numpy leaves) -> state dict
    for ``repro_torch.models.encdec.EncDecLM`` with the same config. Works
    as well on a gradient tree of the same structure."""
    stacks = ("enc_layers", "dec_layers")
    rest = {k: v for k, v in tree.items() if k not in stacks}
    sd = {k: _tensor(v) for k, v in _flatten(rest, "").items()}
    for name in stacks:
        for path, leaf in _flatten(tree[name], "").items():
            for n in range(np.shape(leaf)[0]):
                sd[f"{name}.{n}.{path}"] = _tensor(leaf[n])
    return sd


_DENSE = ("src_embed", "tgt_embed", "attn_q", "out_proj", "head")


def lstm_weight_to_kernel(w: np.ndarray) -> np.ndarray:
    """(D+H, 4H) gate-blocked -> (D+H, H, 4) gate-interleaved."""
    k, h4 = w.shape
    return np.ascontiguousarray(
        np.asarray(w).reshape(k, 4, h4 // 4).transpose(0, 2, 1))


def lstm_bias_to_kernel(b: np.ndarray) -> np.ndarray:
    """(4H,) gate-blocked -> (H, 4)."""
    return np.ascontiguousarray(np.asarray(b).reshape(4, -1).T)


def gnmt_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``repro.models.rnn.GNMT`` params (numpy leaves) -> state dict for
    ``repro_torch.models.rnn.GNMT`` with the same config. Works as well on
    a gradient tree of the same structure."""
    sd: Dict[str, torch.Tensor] = {
        name: torch.from_numpy(np.array(tree[name])) for name in _DENSE}

    def lstm(prefix: str, p: Mapping[str, Any]) -> None:
        sd[f"{prefix}.w"] = torch.from_numpy(lstm_weight_to_kernel(p["w"]))
        sd[f"{prefix}.b"] = torch.from_numpy(lstm_bias_to_kernel(p["b"]))

    lstm("enc_bi_f", tree["enc_bi_f"])
    lstm("enc_bi_b", tree["enc_bi_b"])
    for i, p in enumerate(tree["enc_uni"]):
        lstm(f"enc_uni.{i}", p)
    for i, p in enumerate(tree["dec"]):
        lstm(f"dec.{i}", p)
    return sd


def ds2_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``repro.models.rnn.DS2`` params (numpy leaves) -> state dict for
    ``repro_torch.models.rnn.DS2`` with the same config. Works as well on a
    gradient tree of the same structure."""
    sd: Dict[str, torch.Tensor] = {
        name: torch.from_numpy(np.ascontiguousarray(
            np.asarray(tree[name]).transpose(3, 2, 0, 1)))
        for name in ("conv1", "conv2")}
    for name in ("bn_scale", "bn_bias", "head"):
        sd[name] = torch.from_numpy(np.array(tree[name]))
    for i, pair in enumerate(tree["gru"]):
        for direction, p in zip(("fwd", "bwd"), pair):
            for leaf in ("wzr", "wx", "wh", "b"):
                sd[f"gru.{i}.{direction}.{leaf}"] = torch.from_numpy(
                    np.array(p[leaf]))
    return sd
