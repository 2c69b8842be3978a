"""AdamW with configurable moment dtype + global-norm clipping + schedule
(a port of ``repro.train.optimizer`` on named tensors).

This is not ``torch.optim.AdamW``: as in the reference, the gradients are
clipped by their global norm first, the decay is applied inside the step
(``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``), the decay mask reads
a parameter's last name key, and ``moment_dtype="bfloat16"`` runs the
update arithmetic in bf16 with eps raised to 1e-5. The update writes the
parameters and moments in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping

import torch

from repro_torch.configs.base import OptimizerConfig

Named = Mapping[str, torch.Tensor]


@dataclass
class OptState:
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def init_opt_state(params: Named, cfg: OptimizerConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros() -> Dict[str, torch.Tensor]:
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in params.items()}

    return OptState(step=0, m=zeros(), v=zeros())


def lr_schedule(cfg: OptimizerConfig, total_steps: int
                ) -> Callable[[int], float]:
    """Linear warmup to ``cfg.lr``, then a cosine to a tenth of it; 0 at
    step 0, so the first step moves only the moments."""
    def fn(step: int) -> float:
        warm = min(step / max(cfg.warmup_steps, 1), 1.0)
        frac = min(max((step - cfg.warmup_steps)
                       / max(total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return cfg.lr * warm * (0.1 + 0.9 * cos)
    return fn


def global_norm(tree: Named) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    sq = [g.float().square().sum() for g in tree.values()]
    return torch.stack(sq).sum().sqrt()


def _decayable(name: str) -> bool:
    last = name.split(".")[-1]
    return not any(t in last for t in ("norm", "ln_", "bias", "b_", "mu_",
                                       "w0", "dt_bias"))


@torch.no_grad()
def adamw_update(grads: Named, state: OptState, params: Named,
                 cfg: OptimizerConfig, lr: float) -> Dict[str, torch.Tensor]:
    """One AdamW step: writes ``params``, ``state.m`` and ``state.v`` in
    place, advances ``state.step`` and returns ``{"grad_norm", "lr"}``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0) if cfg.grad_clip > 0 \
        else torch.ones((), device=gnorm.device)
    step = state.step + 1
    mdt = getattr(torch, cfg.moment_dtype)
    # the update runs in the moment dtype for bf16-moment configs, its
    # constants rounded to bf16 first as the reference's weak-typed
    # scalars are
    cdt = torch.float32 if mdt == torch.float32 else torch.bfloat16
    dev = gnorm.device

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def c(x: float) -> torch.Tensor:
        return f32(x).to(cdt)

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = (1.0 - f32(b1) ** step).to(cdt)
    bc2 = (1.0 - f32(b2) ** step).to(cdt)
    eps = c(cfg.eps if cdt == torch.float32 else max(cfg.eps, 1e-5))
    b1c, b2c, nb1, nb2 = c(b1), c(b2), c(1 - b1), c(1 - b2)
    wd, lrc, scale = c(cfg.weight_decay), c(lr), scale.to(cdt)
    for name, p in params.items():
        g = grads[name].to(cdt) * scale
        m, v = state.m[name], state.v[name]
        mn = b1c * m.to(cdt) + nb1 * g
        vn = b2c * v.to(cdt) + nb2 * g.square()
        delta = (mn / bc1) / ((vn / bc2).sqrt() + eps)
        if cfg.weight_decay and _decayable(name):
            delta = delta + wd * p.to(cdt)
        p.copy_(p.to(cdt) - lrc * delta)
        m.copy_(mn)
        v.copy_(vn)
    state.step = step
    return {"grad_norm": gnorm, "lr": lr}
