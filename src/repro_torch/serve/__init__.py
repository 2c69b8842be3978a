"""repro_torch.serve — the serving side of the port.

``engine`` holds the batched prefill+decode executor (``ServeEngine``);
``sched`` holds the SL-aware request-lifecycle scheduler (admission queues,
pluggable policies, and the continuous-batching loop).
"""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
