"""repro_torch.resilience — what serving uses of ``repro.resilience``:
the deterministic fault plan (``REPRO_FAULTS``), the per-SL latency
watchdog, retry with backoff and the replica health set."""
from __future__ import annotations

from repro_torch.resilience import faults
from repro_torch.resilience.elastic import ReplicaSet
from repro_torch.resilience.faults import (
    FaultError,
    FaultPlan,
    FaultSpec,
    PreemptionFault,
    TransientFault,
)
from repro_torch.resilience.guards import StepTimeWatchdog, WatchdogVerdict
from repro_torch.resilience.recovery import (
    RETRYABLE,
    RecoveryPolicy,
    backoff_delay,
    retry_with_backoff,
)

__all__ = [
    "RETRYABLE", "FaultError", "FaultPlan", "FaultSpec", "PreemptionFault",
    "RecoveryPolicy", "ReplicaSet", "StepTimeWatchdog", "TransientFault",
    "WatchdogVerdict", "backoff_delay", "faults", "retry_with_backoff",
]
