"""The train step (a port of ``repro.train.train_step``).

``build_train_step`` returns ``(train_state, batch) -> (train_state,
metrics)``: the loss and its gradients (summed over microbatches in float32
buffers and averaged, as the reference's scan does), the compressed
data-parallel gradient with its error-feedback residual, and one AdamW step.
The state is updated in place; the model owns the parameter tensors that
``TrainState.params`` names. Each phase runs inside a ``torch.profiler``
range (``train_step/forward``, ``/backward``, ``/compress``, ``/adamw``),
so a trace of the real step splits its time; outside a trace a range
costs a few microseconds.

``train_state_from_jax`` maps a whole JAX ``TrainState`` (params, AdamW
step and moments, error-feedback residual) leaf by leaf, for a decoder-only
LM or the encoder-decoder, so a JAX training run can be resumed in the
port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import RunConfig, StepKind
from repro_torch.dist import regions
from repro_torch.dist.regions import reduce_like
from repro_torch.dist.compression import (
    compress_grads,
    decompress_grads,
    init_residual,
)
from repro_torch.models.convert import (
    encdec_params_from_jax,
    transformer_params_from_jax,
)
from repro_torch.models.model_zoo import Model
from repro_torch.train.optimizer import (
    OptState,
    adamw_update,
    init_opt_state,
    lr_schedule,
)

Batch = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt: OptState
    # error-feedback residual for compressed DP gradients; None when the
    # compression method carries no state
    ef: Optional[Dict[str, torch.Tensor]] = None


def init_train_state(model: Model, run: RunConfig) -> TrainState:
    """The model's own parameters (not re-drawn), zero moments and a zero
    residual where the compression method keeps one."""
    params = dict(model.named_parameters())
    return TrainState(params=params,
                      opt=init_opt_state(params, run.optimizer),
                      ef=init_residual(params,
                                       run.optimizer.grad_compression))


def train_state_from_jax(state: Any) -> TrainState:
    """``repro.train.train_step.TrainState`` (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, state)``) -> a ``TrainState`` with fresh CPU
    tensors; ``assign_state`` copies it into a model's own training state.
    The converter follows the parameter tree's keys: a tree with
    ``enc_layers`` is an ``EncDecLM``'s (``encdec_params_from_jax``), any
    other a decoder-only LM's (``transformer_params_from_jax``). The
    moments and the residual have the parameters' tree, so each maps as
    the parameters do."""
    convert = encdec_params_from_jax if "enc_layers" in state.params \
        else transformer_params_from_jax
    opt = state.opt
    return TrainState(
        params=convert(state.params),
        opt=OptState(step=int(np.asarray(opt.step)),
                     m=convert(opt.m), v=convert(opt.v)),
        ef=None if state.ef is None else convert(state.ef))


@torch.no_grad()
def assign_state(state: TrainState, new: TrainState) -> TrainState:
    """Copy ``new`` (a restored checkpoint) into ``state``'s tensors in
    place, so the model's parameters take its values; returns ``state``."""
    pairs = [(state.params, new.params), (state.opt.m, new.opt.m),
             (state.opt.v, new.opt.v)]
    if state.ef is not None:
        pairs.append((state.ef, new.ef))
    for dst, src in pairs:
        for name, t in dst.items():
            t.copy_(src[name])
    state.opt.step = int(new.opt.step)
    return state


def _grad(loss: torch.Tensor, tensors):
    """The gradients of ``tensors``; a parameter the loss does not reach
    gets a zero gradient, as in JAX. A DTensor parameter's gradient is put
    in the parameter's placements (``reduce_like``) by a hook, as soon as
    the backward has formed it: one layer's whole or partial gradient
    lives while that layer's backward runs, not until the step's end (the
    reference's per-layer reduce-scatter)."""
    hooks = [t.register_hook(lambda g, t=t: reduce_like(g, t))
             for t in tensors if regions.is_dtensor(t)]
    try:
        return torch.autograd.grad(loss, tensors, allow_unused=True,
                                   materialize_grads=True)
    finally:
        for h in hooks:
            h.remove()


def _microbatches(v: torch.Tensor, nmicro: int):
    """``v`` cut into ``nmicro`` microbatches along the batch: contiguous
    blocks, as the reference's reshape cuts them. A batch DTensor is cut
    on each rank's own rows (microbatch i holds block i of every data
    shard), so no rows move between ranks."""
    if not regions.is_dtensor(v):
        return v.reshape((nmicro, v.shape[0] // nmicro) + v.shape[1:])
    from torch.distributed.tensor import DTensor

    local = v.to_local()
    parts = local.reshape((nmicro, local.shape[0] // nmicro)
                          + local.shape[1:])
    return [DTensor.from_local(parts[i], v.device_mesh, v.placements,
                               run_check=False) for i in range(nmicro)]


def loss_and_grads(model: Model, batch: Batch, tensors, nmicro: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """The loss, the metrics and the gradients of ``tensors`` on ``batch``
    cut into ``nmicro`` microbatches: float32 sums of each microbatch's
    gradients, averaged, as the reference's scan takes them (the metrics
    are the last microbatch's)."""
    if nmicro == 1:
        with record_function("train_step/forward"):
            loss, metrics = model.loss(batch)
        with record_function("train_step/backward"):
            grads = _grad(loss, tensors)
        return loss.detach(), metrics, grads
    micro = {k: _microbatches(v, nmicro) for k, v in batch.items()}
    # float32 sums in the parameters' placements (``_grad`` has reduced
    # each microbatch's gradient)
    acc = None
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(nmicro):
        with record_function("train_step/forward"):
            mb_loss, metrics = model.loss({k: v[i] for k, v in micro.items()})
        with record_function("train_step/backward"):
            gs = _grad(mb_loss, tensors)
            if acc is None:
                acc = [torch.zeros_like(g, dtype=torch.float32) for g in gs]
            for a, g in zip(acc, gs):
                a.add_(g)
        loss = loss + mb_loss.detach()
    return loss / nmicro, metrics, [a / nmicro for a in acc]


def build_train_step(model: Model, run: RunConfig, total_steps: int = 10_000
                     ) -> Callable[[TrainState, Batch],
                                   Tuple[TrainState, Dict[str, torch.Tensor]]]:
    lr_fn = lr_schedule(run.optimizer, total_steps)
    nmicro = max(run.microbatches, 1)
    method = run.optimizer.grad_compression
    period = len(model.cfg.pattern)

    def train_step(state: TrainState, batch: Batch):
        names = list(state.params)
        loss, metrics, grads = loss_and_grads(
            model, batch, [state.params[n] for n in names], nmicro)
        grads = dict(zip(names, grads))
        metrics = {k: v.detach() for k, v in metrics.items()}

        # compressed DP all-reduce: quantize (grads + residual) to the wire
        # format, apply the decompressed gradient, carry the new residual.
        # Numerically it is replica-identical, so it also runs (and is
        # tested) on a single device.
        if method != "none":
            with record_function("train_step/compress"):
                if state.ef is not None:
                    grads = {n: g + state.ef[n] for n, g in grads.items()}
                wire, err = compress_grads(grads, method, period=period)
                grads = decompress_grads(wire, method, grads, period=period)
                if state.ef is not None:
                    state.ef = err

        lr = lr_fn(state.opt.step)
        with record_function("train_step/adamw"):
            opt_metrics = adamw_update(grads, state.opt, state.params,
                                       run.optimizer, lr)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return state, metrics

    return train_step


def build_serve_step(model: Model, run: RunConfig, kind: StepKind):
    """prefill: ``batch -> (logits, caches)``; decode: ``(caches, token,
    cache_index) -> (logits, caches)``, one token, the caches written in
    place. The reference's steps also take the parameters; the port's
    model holds its own."""
    if kind == StepKind.PREFILL:
        def prefill(batch):
            return model.prefill(batch)
        return prefill

    def decode(caches, token, cache_index):
        return model.decode_step(caches, token, cache_index)
    return decode
