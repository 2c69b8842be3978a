"""``build_model(cfg, runtime, device=, seed=)`` — dispatch to the right
model class; ``build_from_run(run)`` builds a run's model with its
``Runtime``."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import Runtime, TransformerLM

Model = Union[TransformerLM, EncDecLM]


def build_model(cfg: ModelConfig, rt: Optional[Runtime] = None, *,
                device: DeviceLike = "cuda", seed: int = 0) -> Model:
    """Build ``cfg`` with random weights from ``seed`` on ``device`` (the
    CUDA card unless the caller asks for the CPU; ``"meta"`` builds the
    shapes alone, for the sharding rules): ``EncDecLM`` for a config with
    an encoder, ``TransformerLM`` for every other."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(device)
    if cfg.encoder is not None:
        return EncDecLM(cfg, rt, device=dev, seed=seed)
    return TransformerLM(cfg, rt, device=dev, seed=seed)


def build_from_run(run: RunConfig, *, device: DeviceLike = "cuda") -> Model:
    """``run.model`` with ``Runtime.from_run(run)`` and ``run.seed``'s
    weights."""
    return build_model(run.model, Runtime.from_run(run), device=device,
                       seed=run.seed)
