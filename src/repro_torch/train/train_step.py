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

from repro_torch.configs.base import RunConfig
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
    # a parameter the loss does not reach gets a zero gradient, as in JAX
    return torch.autograd.grad(loss, tensors, allow_unused=True,
                               materialize_grads=True)


def build_train_step(model: Model, run: RunConfig, total_steps: int = 10_000
                     ) -> Callable[[TrainState, Batch],
                                   Tuple[TrainState, Dict[str, torch.Tensor]]]:
    lr_fn = lr_schedule(run.optimizer, total_steps)
    nmicro = max(run.microbatches, 1)
    method = run.optimizer.grad_compression
    period = len(model.cfg.pattern)

    def train_step(state: TrainState, batch: Batch):
        names = list(state.params)
        tensors = [state.params[n] for n in names]
        if nmicro == 1:
            with record_function("train_step/forward"):
                loss, metrics = model.loss(batch)
            with record_function("train_step/backward"):
                grads = dict(zip(names, _grad(loss, tensors)))
            loss = loss.detach()
        else:
            micro = {k: v.reshape((nmicro, v.shape[0] // nmicro)
                                  + v.shape[1:]) for k, v in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tensors]
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(nmicro):
                with record_function("train_step/forward"):
                    mb_loss, metrics = model.loss({k: v[i]
                                                   for k, v in micro.items()})
                with record_function("train_step/backward"):
                    for a, g in zip(acc, _grad(mb_loss, tensors)):
                        a.add_(g)
                loss = loss + mb_loss.detach()
            loss = loss / nmicro
            grads = {n: a / nmicro for n, a in zip(names, acc)}
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
