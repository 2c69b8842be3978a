"""Recovery mechanics: retry-with-backoff, poison-batch skip lists, and
crash-consistent train-state snapshots (a copy of
``repro.resilience.recovery``).

Four recovery tiers, cheapest first:

1. **Retry** (`retry_with_backoff`) — transient faults (flaky loader,
   hiccuping checkpoint disk, one failed decode) are retried with capped,
   jittered exponential backoff; every retry is an obs event + counter.
   The jitter is deterministic per ``(jitter_seed, label, attempt)`` — N
   replicas retrying the same fault with distinct seeds desynchronize
   (no thundering herd) while any single replica's chaos replay is
   bit-identical.
2. **Rollback** — a guard violation (NaN/inf loss, divergence) restores the
   last good checkpoint *including* the data-iterator state and the partial
   EpochLog, so the replayed steps re-log identically and SeqPoint
   selection is unaffected by the excursion. A batch that keeps failing
   after rollback (`BatchSkipList`) is declared poison and skipped.
3. **Preemption-safe resume** — a simulated preemption writes an emergency
   checkpoint whose ``extra`` carries the iterator position *of the
   interrupted batch*, the partial EpochLog, **and the skip list** (so a
   poison batch stays poison across process restarts); the resumed process
   re-fetches that exact batch and continues the log bit-for-bit.
4. **Elastic re-mesh** (`resilience.elastic` + the trainer's tier-4 arm) —
   a confirmed peer loss checkpoints, shrinks the mesh over the survivors,
   re-shards the restored state, and resumes in-process.

`pack_train_extra` / `unpack_train_extra` define the crash-consistency
contract between the trainer and the checkpoint manifest.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, TypeVar

from repro_torch import obs
from repro_torch.core.profile import EpochLog
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


class BatchSkipList:
    """Failure counts per batch key; a batch that causes ``skip_after``
    rollbacks is poison and gets skipped on the next replay.

    Keys are (epoch, batch_index) — the deterministic identity of a batch in
    the resumable iterator, stable across rollbacks and process restarts
    within one plan. ``state()`` / ``restore()`` round-trip through the
    checkpoint ``extra`` payload so poison status survives a preemption
    (a resumed process must not pay the discovery rollbacks again).
    """

    def __init__(self, skip_after: int = 2):
        self.skip_after = max(1, int(skip_after))
        self._failures: Dict[Any, int] = {}
        self._skip: set = set()

    def record_failure(self, key: Any) -> bool:
        """Note a rollback caused at ``key``; True once it becomes poison."""
        n = self._failures.get(key, 0) + 1
        self._failures[key] = n
        if n >= self.skip_after:
            self._skip.add(key)
        return key in self._skip

    def should_skip(self, key: Any) -> bool:
        return key in self._skip

    @property
    def poisoned(self) -> set:
        return set(self._skip)

    # ------------------------------------------------------------------
    def state(self) -> dict:
        """JSON-able snapshot (tuple keys become lists on the wire)."""
        return {"failures": [[list(k), n]
                             for k, n in sorted(self._failures.items())],
                "skip": [list(k) for k in sorted(self._skip)]}

    def restore(self, state: Optional[dict]) -> None:
        """Merge a ``state()`` snapshot (failure counts take the max side,
        so an in-memory superset is never clobbered by an older snapshot)."""
        if not state:
            return
        for k, n in state.get("failures", []):
            key = tuple(k)
            self._failures[key] = max(self._failures.get(key, 0), int(n))
        for k in state.get("skip", []):
            self._skip.add(tuple(k))


# --------------------------------------------------------------------------
# crash-consistency contract for the checkpoint ``extra`` payload


def pack_train_extra(step: int, data_state: Dict[str, int],
                     epoch_log: EpochLog,
                     skiplist: Optional[BatchSkipList] = None) -> dict:
    extra = {"step": int(step), "data_state": dict(data_state),
             "epoch_log": epoch_log.to_jsonable()}
    if skiplist is not None:
        extra["skiplist"] = skiplist.state()
    return extra


def unpack_train_extra(extra: dict) -> Tuple[int, Optional[Dict[str, int]],
                                             Optional[EpochLog],
                                             Optional[dict]]:
    step = int(extra["step"])
    data_state = extra.get("data_state")
    log = EpochLog.from_jsonable(extra["epoch_log"]) \
        if "epoch_log" in extra else None
    return step, data_state, log, extra.get("skiplist")
