"""repro_torch.resilience — fault injection, training guardrails, and
crash-consistent recovery (a copy of ``repro.resilience``).

``faults`` is the deterministic chaos switchboard (env-driven via
``REPRO_FAULTS``), ``guards`` are the training-health invariants,
``recovery`` holds retries, skip lists, and the crash-consistency contract
for checkpoint extras, and ``elastic`` models multi-host failure domains
(peer-loss detection, elastic re-meshing, serve replica health).
"""
from __future__ import annotations

from repro_torch.resilience import elastic, faults
from repro_torch.resilience.elastic import (
    ClusterFailure,
    ClusterMonitor,
    FailureDomains,
    HealthVerdict,
    PeerHealthTracker,
    PeerLossFault,
    ReplicaSet,
    reshard_state,
)
from repro_torch.resilience.faults import (
    FaultError,
    FaultPlan,
    FaultSpec,
    PreemptionFault,
    TransientFault,
)
from repro_torch.resilience.guards import (
    DivergenceDetector,
    DivergenceError,
    GuardViolation,
    NonFiniteLossError,
    StepTimeWatchdog,
    WatchdogVerdict,
    check_finite,
)
from repro_torch.resilience.recovery import (
    RETRYABLE,
    BatchSkipList,
    RecoveryPolicy,
    backoff_delay,
    pack_train_extra,
    retry_with_backoff,
    unpack_train_extra,
)

__all__ = [
    "RETRYABLE", "BatchSkipList", "ClusterFailure", "ClusterMonitor",
    "DivergenceDetector", "DivergenceError", "FailureDomains", "FaultError",
    "FaultPlan", "FaultSpec", "GuardViolation", "HealthVerdict",
    "NonFiniteLossError", "PeerHealthTracker", "PeerLossFault",
    "PreemptionFault", "RecoveryPolicy", "ReplicaSet", "StepTimeWatchdog",
    "TransientFault", "WatchdogVerdict", "backoff_delay", "check_finite",
    "elastic", "faults", "pack_train_extra", "reshard_state",
    "retry_with_backoff", "unpack_train_extra",
]
