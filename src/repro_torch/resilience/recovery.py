"""Retry-with-backoff (a copy of ``repro.resilience.recovery``'s first
tier; skip lists and the checkpoint contract come with the training slice).

Transient faults (one failed decode) are retried with capped, jittered
exponential backoff; every retry is an obs event + counter. The jitter is
deterministic per ``(jitter_seed, label, attempt)`` — N replicas retrying
the same fault with distinct seeds desynchronize (no thundering herd) while
any single replica's chaos replay is bit-identical.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Callable, TypeVar

from repro_torch import obs
from repro_torch.resilience.faults import TransientFault

T = TypeVar("T")

RETRYABLE = (TransientFault, OSError)


@dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for the four recovery tiers (one object, threaded through
    trainer and serve engine)."""

    max_retries: int = 3            # per retryable operation
    backoff_base_s: float = 0.02    # first retry delay; doubles per attempt
    backoff_factor: float = 2.0
    max_delay_s: float = 2.0        # backoff cap (exponential stops here)
    jitter_frac: float = 0.25       # +/- fraction of the delay, seeded
    jitter_seed: int = 0            # per-replica seed decorrelates retries
    max_rollbacks: int = 8          # per train() call; then re-raise
    skip_after_failures: int = 2    # rollbacks on one batch before skipping
    divergence_ratio: float = 4.0   # loss vs EMA (guards.DivergenceDetector)
    divergence_patience: int = 5
    check_grads: bool = True        # guard grad_norm finiteness too
    max_remeshes: int = 2           # tier-4 elastic re-meshes per train()


def backoff_delay(attempt: int, *, base_delay: float = 0.02,
                  factor: float = 2.0, max_delay_s: float = 2.0,
                  jitter_frac: float = 0.25, jitter_seed: int = 0,
                  label: str = "") -> float:
    """Delay before retry ``attempt`` (1-based): capped exponential with
    deterministic seeded jitter.

    The jitter draw is keyed by ``(jitter_seed, label, attempt)`` via the
    same crc32 construction the fault plan uses, so a chaos replay with the
    same seed sleeps identically while replicas with different seeds spread
    over ``[1 - jitter_frac, 1 + jitter_frac] * delay``.
    """
    d = min(base_delay * (factor ** (attempt - 1)), max_delay_s)
    if d > 0.0 and jitter_frac > 0.0:
        key = f"{jitter_seed}:{label}:{attempt}".encode()
        u = (zlib.crc32(key) & 0xFFFFFFFF) / float(0x100000000)  # [0, 1)
        d *= 1.0 + jitter_frac * (2.0 * u - 1.0)
        d = min(d, max_delay_s)
    return d


def retry_with_backoff(fn: Callable[[], T], *, retries: int = 3,
                       base_delay: float = 0.02, factor: float = 2.0,
                       max_delay_s: float = 2.0, jitter_frac: float = 0.25,
                       jitter_seed: int = 0,
                       retryable: tuple = RETRYABLE,
                       sleep: Callable[[float], None] = time.sleep,
                       label: str = "") -> T:
    """Call ``fn`` until it succeeds or ``retries`` retryable failures.

    Non-retryable exceptions (including ``PreemptionFault``) propagate
    immediately; the last retryable failure is re-raised unchanged.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:                         # noqa: PERF203
            attempt += 1
            if attempt > retries:
                raise
            d = backoff_delay(attempt, base_delay=base_delay, factor=factor,
                              max_delay_s=max_delay_s,
                              jitter_frac=jitter_frac,
                              jitter_seed=jitter_seed, label=label)
            obs.metrics.counter("resilience_retries_total",
                                label=label or "unlabeled").inc()
            obs.event("retry", label=label, attempt=attempt,
                      delay_s=d, error=repr(e))
            if d > 0:
                sleep(d)
