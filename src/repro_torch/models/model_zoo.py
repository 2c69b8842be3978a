"""``build_model(cfg, runtime, device=, seed=)`` — dispatch to the right
model class."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Runtime, TransformerLM

Model = TransformerLM


def build_model(cfg: ModelConfig, rt: Optional[Runtime] = None, *,
                device: DeviceLike = "cuda", seed: int = 0) -> Model:
    """Build ``cfg`` with random weights from ``seed`` on ``device`` (the
    CUDA card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models (models/encdec.py) come "
            "with the whisper slice")
    return TransformerLM(cfg, rt, device=dev, seed=seed)
