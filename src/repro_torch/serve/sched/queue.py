"""SL-bucketed admission queues (SeqPoint's binning applied to serving).

A copy of ``repro.serve.sched.queue``.

Requests are queued by the log2 bucket of their prompt SL — the same
``bucket_bound`` geometry ``repro_torch.obs`` uses for its histograms, so
queue metrics, step-time histograms, and admission decisions all speak the
same bucket language. Within a bucket the order is strict FIFO by a global
arrival sequence number, which is what makes scheduler runs replayable:
admission order is a pure function of (request set, policy, fault plan).

A ``Ticket`` is the queue's view of a request: arrival seq, submit time,
raw prompt SL, and the padded width the scheduler would prefill it at
(its bucket bound, capped at the engine's ``max_len``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

from repro_torch import obs
from repro_torch.obs.metrics import bucket_bound

if TYPE_CHECKING:                                    # avoid an import cycle
    from repro_torch.serve.engine import Request


def sl_bucket(sl: int) -> int:
    """Log2 bucket of a prompt SL: smallest power of two >= sl (min 1)."""
    return int(bucket_bound(max(1, int(sl))))


@dataclass(eq=False)                     # identity equality: Request holds
class Ticket:                            # arrays, field-wise == is ambiguous
    req: "Request"
    seq: int                 # global arrival order (admission tiebreaker)
    t_submit: float
    sl: int                  # raw prompt length
    padded: int              # log2-bucket width the prefill would run at

    @property
    def bucket(self) -> int:
        return self.padded


class AdmissionQueue:
    """Per-bucket FIFO queues with a global arrival order.

    ``submit`` assigns the arrival seq and updates the per-bucket
    ``serve_sched_queue_depth`` gauge; ``take`` removes admitted tickets.
    ``eligible`` applies the continuous-batching admission constraints
    (padded width must fit under the current write position, the remaining
    decode budget must fit under ``max_len``) without consuming anything.
    """

    def __init__(self, max_len: int = 512, *,
                 timer: Callable[[], float] = None,
                 max_depth: Optional[int] = None):
        import time
        self.max_len = int(max_len)
        self.max_depth = max_depth
        self._now = timer or time.perf_counter
        self._buckets: Dict[int, List[Ticket]] = {}
        self._seq = 0
        self.submitted = 0
        self.shed = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> Optional[Ticket]:
        """Queue a request; returns its Ticket, or None if shed on a full
        queue (``req.shed`` is set so the caller can requeue later)."""
        if self.max_depth is not None and self.depth() >= self.max_depth:
            req.shed = True
            self.shed += 1
            obs.metrics.counter("serve_shed_total").inc()
            obs.event("serve_shed", count=1, queued=self.depth())
            return None
        req.shed = False
        padded = min(self.max_len, sl_bucket(len(req.prompt)))
        t = Ticket(req=req, seq=self._seq, t_submit=self._now(),
                   sl=int(len(req.prompt)), padded=padded)
        self._seq += 1
        self.submitted += 1
        self._buckets.setdefault(padded, []).append(t)
        obs.metrics.gauge("serve_sched_queue_depth",
                          bucket=padded).set(len(self._buckets[padded]))
        return t

    def take(self, tickets: List[Ticket]) -> None:
        for t in tickets:
            self._buckets[t.padded].remove(t)
            obs.metrics.gauge("serve_sched_queue_depth", bucket=t.padded
                              ).set(len(self._buckets[t.padded]))

    # ------------------------------------------------------------------
    def depth(self, bucket: Optional[int] = None) -> int:
        if bucket is not None:
            return len(self._buckets.get(bucket, []))
        return sum(len(q) for q in self._buckets.values())

    def buckets(self) -> List[int]:
        return sorted(b for b, q in self._buckets.items() if q)

    def pending(self) -> List[Ticket]:
        """All queued tickets in arrival order."""
        out = [t for q in self._buckets.values() for t in q]
        out.sort(key=lambda t: t.seq)
        return out

    def oldest(self) -> Optional[Ticket]:
        p = self.pending()
        return p[0] if p else None

    def eligible(self, *, pos: Optional[int] = None,
                 budget: Optional[int] = None) -> List[Ticket]:
        """Tickets admissible right now, in arrival order.

        ``pos``: current shared write position — a ticket's padded prompt
        must fit in [pos - padded, pos), so ``padded <= pos``. ``budget``:
        remaining decode positions before ``max_len`` — the request's
        decode tail (``max_new_tokens - 1`` steps past admission) must fit.
        Either constraint may be None (unconstrained, e.g. a fresh wave).
        """
        out = []
        for t in self.pending():
            if pos is not None and t.padded > pos:
                continue
            if budget is not None and max(0, t.req.max_new_tokens - 1) > \
                    budget:
                continue
            out.append(t)
        return out
