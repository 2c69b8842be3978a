"""repro_torch.serve.sched — SL-aware continuous-batching scheduler.

SeqPoint's observation (per-iteration compute is keyed by padded SL)
applied to the serving request lifecycle: log2-SL-bucketed admission
queues (``queue``), pluggable admission policies (``policy``), and a
continuous-batching loop that admits into free decode slots at step
granularity and evicts finished sequences immediately (``loop``). Entry
point: ``ServeEngine.serve(requests, policy=...)``; baseline comparison:
``loop.run_to_completion``.
"""
from repro_torch.serve.sched.loop import (
    ContinuousBatcher,
    ServeStats,
    run_to_completion,
)
from repro_torch.serve.sched.policy import (
    AdmissionPolicy,
    BucketAffinePolicy,
    FifoPolicy,
    SeqPointPolicy,
    cost_from_provider,
)
from repro_torch.serve.sched.queue import AdmissionQueue, Ticket, sl_bucket

__all__ = [
    "AdmissionPolicy", "AdmissionQueue", "BucketAffinePolicy",
    "ContinuousBatcher", "FifoPolicy", "SeqPointPolicy", "ServeStats",
    "Ticket", "cost_from_provider", "run_to_completion", "sl_bucket",
]
