"""Pluggable admission policies for the continuous-batching scheduler.

A copy of ``repro.serve.sched.policy``.

A policy answers one question: given the eligible tickets (arrival order)
and ``n_slots`` free slots, which requests enter the batch now? All three
shipped policies are deterministic — same queue state in, same admission
out — which is what the scheduler's replayability contract requires.

* ``FifoPolicy`` — arrival order, SL-blind. The baseline: a 512-SL prompt
  landing next to an 8-SL prompt pads the whole micro-batch to 512.
* ``BucketAffinePolicy`` — anchors on the oldest ticket (no starvation),
  then prefers tickets from the same log2 bucket, then the nearest
  buckets. Minimizes padded width without an explicit cost model.
* ``SeqPointPolicy`` — weighs candidates with a per-SL cost model (e.g.
  ``core.characterize`` provider runtimes): picks the admission set that
  maximizes useful-compute per padded-compute, SeqPoint's per-SL cost
  observation applied to batch formation. Falls back to bucket-affine
  ordering when costs tie.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

from repro_torch.serve.sched.queue import Ticket


class AdmissionPolicy:
    name = "base"

    def select(self, tickets: Sequence[Ticket],
               n_slots: int) -> List[Ticket]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class FifoPolicy(AdmissionPolicy):
    """Strict arrival order, blind to SL (the run-to-completion default)."""

    name = "fifo"

    def select(self, tickets: Sequence[Ticket],
               n_slots: int) -> List[Ticket]:
        return list(tickets[:max(0, n_slots)])


class BucketAffinePolicy(AdmissionPolicy):
    """Admit the oldest ticket, then pack its log2 bucket first.

    The oldest eligible request is always admitted — aging beats packing,
    so no bucket can starve another. Remaining slots are filled from the
    anchor's bucket in FIFO order, then from other buckets by increasing
    padded-width distance to the anchor (ties: smaller bucket first, then
    arrival order). Narrower buckets join a wide batch for free; admitting
    a wider ticket raises the batch width, so it comes last.
    """

    name = "bucket_affine"

    def select(self, tickets: Sequence[Ticket],
               n_slots: int) -> List[Ticket]:
        if not tickets or n_slots <= 0:
            return []
        anchor = min(tickets, key=lambda t: t.seq)
        rest = [t for t in tickets if t is not anchor]
        rest.sort(key=lambda t: (abs(t.padded - anchor.padded),
                                 t.padded, t.seq))
        return [anchor] + rest[:n_slots - 1]


class SeqPointPolicy(AdmissionPolicy):
    """Cost-model-weighted admission (SeqPoint applied to batch formation).

    ``cost(sl)`` gives the per-iteration compute of a padded-SL-``sl``
    batch — a ``core.characterize`` provider's per-SL runtime, an SLTable
    lookup, or any monotone proxy (``lambda sl: sl`` reproduces grid
    area). For every candidate batch width ``W`` (the padded width of some
    eligible ticket at least as wide as the oldest one), the policy packs
    the oldest ticket plus the highest-cost tickets with ``padded <= W``
    (ties broken by arrival) and scores the set by

        sum(cost(padded_i)) / (n_slots * cost(W))

    — the useful fraction of the compute the padded batch will burn.
    Packing cost-descending matters: filling a wide wave with whatever
    arrived first dilutes it with cheap narrow tickets, while grouping
    the wide ones lets the narrow ones ride a later, narrower wave. The
    best-scoring width wins; the oldest eligible ticket is always in the
    set, so aging is preserved.
    """

    name = "seqpoint"

    def __init__(self, cost: Callable[[int], float]):
        self.cost = cost

    def __repr__(self) -> str:
        return "SeqPointPolicy(cost=...)"

    def select(self, tickets: Sequence[Ticket],
               n_slots: int) -> List[Ticket]:
        if not tickets or n_slots <= 0:
            return []
        anchor = min(tickets, key=lambda t: t.seq)
        widths = sorted({t.padded for t in tickets if t.padded >=
                         anchor.padded})
        best, best_score = None, -1.0
        for w in widths:
            pool = sorted((t for t in tickets
                           if t.padded <= w and t is not anchor),
                          key=lambda t: (-float(self.cost(t.padded)),
                                         t.seq))
            cands = [anchor] + pool[:n_slots - 1]
            denom = n_slots * max(float(self.cost(w)), 1e-12)
            score = sum(float(self.cost(t.padded)) for t in cands) / denom
            if score > best_score + 1e-12:
                best, best_score = cands, score
        return best or [anchor]


def cost_from_provider(provider) -> Callable[[int], float]:
    """Adapt a ``core.characterize`` provider (``profile(sl).runtime``)
    into a ``SeqPointPolicy`` cost model."""
    def cost(sl: int) -> float:
        return float(provider.profile(int(sl)).runtime)
    return cost
