"""Continuous-batching engine loop: slot admission at decode-step
granularity (a port of ``repro.serve.sched.loop``).

The run-to-completion ``ServeEngine.run_batch`` admits a batch, prefills
it, decodes every request to its last token, and only then looks at the
queue again — short sequences pay for the longest one twice (padding at
prefill, idle slots at decode). This loop keeps the engine's ``batch_size``
decode slots independently occupied instead:

* a finished sequence is evicted the moment its last token is emitted and
  its slot is free for the very next admission check;
* new requests are admitted *mid-stream* between decode steps: their
  prompt is prefilled right-aligned at the shared write position ``pos``
  (absolute rope offset ``pos - W``) and the resulting KV rows are spliced
  into the live cache, so active slots never stop decoding;
* admission is SL-aware: the queue is log2-bucketed (same geometry as the
  ``repro_torch.obs`` histograms) and a pluggable policy picks which
  buckets to pack together (``policy.py``), keeping the padded prefill
  width honest.

Shared-position invariant: all slots advance one shared cache position per
decode step, so a request is only splice-admissible once its padded width
fits under ``pos`` (``padded <= pos``) and its decode tail fits under
``max_len``. When the engine fully drains, the position resets with a
fresh prefill wave. Cache rows of an admitted slot below its prompt are
zeroed; the attention mask still ranges over ``[0, pos]``, so those zero
keys act as a shared null attention sink — the documented semantic delta
vs run-to-completion padding (which attends pad-token KV instead). The
scheduler's determinism, accounting, and cost behavior do not depend on
it. Decode writes into the live cache in place; a splice writes the
admitted rows only.

Resilience composition: injected ``decode`` faults fire inside the loop's
decode step and are retried with the engine's backoff policy; ``peer_slow``
fires per admission prefill (the micro-batch), and with ``n_replicas > 1``
a prefill running ``hedge_factor``× past its per-width median is hedged
onto the next-healthiest replica — first (virtual) finisher wins, the
loser takes a strike. Per-request deadlines (``engine.deadline_s``,
clocked from admission) curtail mid-decode with ``curtailed=True``, and a
bounded queue (``max_queue``) sheds instead of growing without limit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.resilience import faults
from repro_torch.resilience.guards import StepTimeWatchdog
from repro_torch.resilience.recovery import retry_with_backoff
from repro_torch.serve.sched.policy import AdmissionPolicy, BucketAffinePolicy
from repro_torch.serve.sched.queue import AdmissionQueue, Ticket


@dataclass
class ServeStats:
    """Deterministic accounting of one scheduler (or baseline) run.

    Grid cells are the padded compute proxy SeqPoint's SL observation
    rests on: every prefill burns ``batch_size x width`` cells and every
    decode step ``batch_size`` cells, useful or not. ``padding_waste`` and
    ``grid_throughput`` are therefore clock-free and bit-stable across
    runs, while ``throughput`` uses the (possibly fake) wall clock.
    """

    n_requests: int = 0
    n_finished: int = 0
    n_curtailed: int = 0
    n_shed: int = 0
    tokens_out: int = 0
    prefills: int = 0
    decode_steps: int = 0
    prefill_cells: int = 0
    prefill_useful: int = 0
    decode_cells: int = 0
    decode_useful: int = 0
    wall_s: float = 0.0
    admission_order: List[int] = field(default_factory=list)

    @property
    def total_cells(self) -> int:
        return self.prefill_cells + self.decode_cells

    @property
    def total_useful(self) -> int:
        return self.prefill_useful + self.decode_useful

    @property
    def padding_waste(self) -> float:
        return 1.0 - self.total_useful / self.total_cells \
            if self.total_cells else 0.0

    @property
    def grid_throughput(self) -> float:
        """Useful tokens emitted per padded grid cell (clock-free)."""
        return self.tokens_out / self.total_cells if self.total_cells \
            else 0.0

    @property
    def throughput(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "n_requests": self.n_requests, "n_finished": self.n_finished,
            "n_curtailed": self.n_curtailed, "n_shed": self.n_shed,
            "tokens_out": self.tokens_out, "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "padding_waste": self.padding_waste,
            "grid_throughput": self.grid_throughput,
            "throughput": self.throughput, "wall_s": self.wall_s,
        }


@dataclass(eq=False)
class _Slot:
    """One occupied decode slot: the admitted ticket plus its per-slot
    KV/state occupancy window and token progress."""

    ticket: Ticket
    t_admit: float
    start: int               # first cache position of its prompt
    width: int               # padded prompt width actually prefilled
    m_eff: int               # effective token budget (capacity-clamped)
    emitted: int = 0
    ttft_s: float = float("nan")   # submit -> first token

    @property
    def done(self) -> bool:
        return self.emitted >= self.m_eff


class ContinuousBatcher:
    """The request-lifecycle scheduler around one ``ServeEngine``."""

    def __init__(self, engine, *, policy: Optional[AdmissionPolicy] = None,
                 max_queue: Optional[int] = None):
        self.engine = engine
        self.policy = policy or BucketAffinePolicy()
        self.queue = AdmissionQueue(engine.max_len, timer=engine._now,
                                    max_depth=max_queue)
        self.slots: List[Optional[_Slot]] = [None] * engine.batch_size
        self.pos = 0                     # shared cache write position
        self.cache = None
        self.token = torch.zeros((engine.batch_size, 1), dtype=torch.long,
                                 device=engine.device)
        self.stats = ServeStats()
        # per-width prefill latency baseline for micro-batch hedging
        self.prefill_watchdog = StepTimeWatchdog(
            factor=engine.hedge_factor)

    # -- queue side -----------------------------------------------------
    def submit(self, req) -> Optional[Ticket]:
        self.stats.n_requests += 1
        t = self.queue.submit(req)
        if t is None:
            self.stats.n_shed += 1
        return t

    # -- admission ------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _admit(self, fresh: bool) -> int:
        """Admit eligible requests into free slots; returns #admitted.

        ``fresh``: the engine is drained — reset the shared position and
        the cache, and admit without the position constraint.
        """
        eng = self.engine
        free = self._free_slots()
        if not free or not self.queue.depth():
            return 0
        if fresh:
            eligible = self.queue.eligible()
        else:
            eligible = self.queue.eligible(
                pos=self.pos, budget=eng.max_len - self.pos)
        picked = self.policy.select(eligible, len(free))
        if not picked:
            return 0
        self.queue.take(picked)
        width = max(t.padded for t in picked)
        if fresh:
            self.pos = width
            self.cache = None
            self.token = torch.zeros((eng.batch_size, 1), dtype=torch.long,
                                     device=eng.device)
            for i in range(eng.batch_size):
                self.slots[i] = None
        start = self.pos - width
        rows = free[:len(picked)]

        toks = np.zeros((eng.batch_size, width), np.int32)
        useful = 0
        for row, t in zip(rows, picked):
            prompt = np.asarray(t.req.prompt, np.int32)[-width:]
            if len(prompt):
                toks[row, -len(prompt):] = prompt
            useful += min(t.sl, width)
        self.stats.prefills += 1
        self.stats.prefill_cells += eng.batch_size * width
        self.stats.prefill_useful += useful
        obs.metrics.counter("serve_sched_prefills_total").inc()
        obs.metrics.histogram("serve_sched_prefill_fill",
                              sl=width).observe(len(picked) /
                                                eng.batch_size)

        logits, caches, latency = self._prefill_hedged(toks, start, width,
                                                       len(picked))
        self.prefill_watchdog.observe(width, latency)
        self._splice(caches, rows, start, width)
        first = logits[:, -1].argmax(dim=-1).tolist()
        tok = self.token.cpu().numpy().copy()
        now = eng._now()
        # positions [pos, max_len) remain for decode: m_eff - 1 decode
        # writes land at pos .. pos + m_eff - 2, so the tail always fits
        budget = eng.max_len - self.pos + 1
        for row, t in zip(rows, picked):
            tok[row, 0] = int(first[row])
            m_eff = max(0, min(t.req.max_new_tokens, budget))
            slot = _Slot(ticket=t, t_admit=now, start=start, width=width,
                         m_eff=m_eff)
            self.slots[row] = slot
            self.stats.admission_order.append(t.seq)
            obs.metrics.counter("serve_sched_admitted_total",
                                bucket=t.padded).inc()
            if m_eff > 0:                 # first token comes from prefill
                t.req.output.append(int(first[row]))
                slot.emitted = 1
                slot.ttft_s = now - t.t_submit
                self.stats.tokens_out += 1
                obs.metrics.histogram("serve_sched_ttft_s", sl=t.padded
                                      ).observe(slot.ttft_s)
            if slot.done:
                self._evict(row, curtailed=m_eff < t.req.max_new_tokens)
        self.token = torch.as_tensor(tok, device=eng.device)
        self._set_occupancy()
        return len(picked)

    def _prefill_hedged(self, toks: np.ndarray, pos0: int, width: int,
                        n_adm: int):
        """One admission prefill (a micro-batch), hedged across replicas.

        A ``peer_slow`` fault at the execution index adds a virtual delay
        to this prefill only; if the virtual latency runs past
        ``hedge_factor`` x the per-width median baseline and another
        replica is available, the prefill is re-issued there and the
        faster (virtual) execution's latency is the one committed.
        """
        eng = self.engine

        def one_exec():
            idx = eng._exec_index
            eng._exec_index += 1
            spec = faults.check("peer_slow", idx)
            penalty = float(spec.delay) if spec is not None else 0.0
            t0 = eng._now()
            with obs.span("serve/sched/prefill", sl=width, batch=n_adm):
                logits, caches = eng._prefill({"tokens": eng._tokens(toks)},
                                              pos0)
                eng._sync()
            return logits, caches, eng._now() - t0 + penalty

        primary = eng.replicas.pick_primary()
        logits, caches, latency = one_exec()
        baseline = self.prefill_watchdog.baseline(width)
        cutoff = eng.hedge_factor * baseline \
            if baseline is not None and eng.replicas.n > 1 else None
        if cutoff is not None and latency > cutoff:
            hedge_replica = eng.replicas.pick_hedge(exclude=primary)
            obs.metrics.counter("serve_hedges_total").inc()
            obs.event("hedge_fired", sl=width, primary=primary,
                      hedge_replica=hedge_replica, at_s=latency,
                      baseline_s=baseline, factor=eng.hedge_factor,
                      micro_batch=True)
            h_logits, h_caches, h_latency = one_exec()
            # the hedge starts at the detection instant — the earliest the
            # watchdog could have fired is the cutoff itself
            h_total = cutoff + h_latency
            if h_total < latency:
                eng.replicas.mark_slow(primary)
                eng.replicas.mark_ok(hedge_replica)
                obs.metrics.counter("serve_hedge_wins_total").inc()
                obs.event("hedge_won", sl=width, winner=hedge_replica,
                          latency_s=h_total, primary_latency_s=latency)
                obs.event("hedge_cancelled", sl=width, loser=primary,
                          wasted_tokens=0)
                return h_logits, h_caches, h_latency
            eng.replicas.mark_ok(primary)
            obs.event("hedge_cancelled", sl=width, loser=hedge_replica,
                      wasted_tokens=0)
        else:
            eng.replicas.mark_ok(primary)
        return logits, caches, latency

    def _splice(self, caches, rows: List[int], start: int,
                width: int) -> None:
        """Write the prefill's rows into the live cache; the other rows are
        left alone.

        A layer's KV pair takes the windowed splice: admitted rows are
        zeroed first (dropping the evicted occupant's stale KV), then the
        prompt window [start, start+width) is written. A recurrent layer's
        leaves (shift, state) are replaced row-wise. The kind of layer
        decides, not the leaves' shapes (the reference guesses by shape).
        """
        eng = self.engine
        if self.cache is None:
            self.cache = eng.model.init_cache(eng.batch_size, eng.max_len)
        idx = torch.as_tensor(rows, dtype=torch.long, device=eng.device)
        for dst, src in zip(self.cache, caches):
            if isinstance(dst, dict):
                for part, leaves in dst.items():
                    for name, d in leaves.items():
                        d[idx] = src[part][name][idx].to(d.dtype)
                continue
            for d, s in zip(dst, src):
                d[idx] = 0
                d[idx, start:start + width] = s[idx].to(d.dtype)

    # -- decode / eviction ----------------------------------------------
    def _decode_once(self) -> None:
        eng = self.engine
        active = self._active()
        with obs.span("serve/sched/decode_token", pos=self.pos,
                      active=len(active)):
            def decode_once():
                faults.fire("decode", eng._decode_calls)
                return eng._decode(self.cache, self.token, self.pos)
            logits, self.cache = retry_with_backoff(
                decode_once, retries=eng.policy.max_retries,
                base_delay=eng.policy.backoff_base_s,
                factor=eng.policy.backoff_factor,
                max_delay_s=eng.policy.max_delay_s,
                jitter_frac=eng.policy.jitter_frac,
                jitter_seed=eng.policy.jitter_seed,
                label="serve_sched_decode")
            eng._decode_calls += 1
            self.token = logits.argmax(dim=-1)[:, None]
            tok = self.token[:, 0].tolist()          # synchronizes
        self.pos += 1
        self.stats.decode_steps += 1
        self.stats.decode_cells += eng.batch_size
        obs.metrics.counter("serve_sched_decode_steps_total").inc()

        for i in active:
            slot = self.slots[i]
            slot.ticket.req.output.append(int(tok[i]))
            slot.emitted += 1
            self.stats.tokens_out += 1
            self.stats.decode_useful += 1
            if slot.done:
                self._evict(i, curtailed=slot.m_eff <
                            slot.ticket.req.max_new_tokens)

    def _evict(self, row: int, *, curtailed: bool) -> None:
        """Free a slot the moment its sequence is finished (or cut)."""
        eng = self.engine
        slot = self.slots[row]
        self.slots[row] = None
        t = slot.ticket
        now = eng._now()
        t.req.curtailed = bool(curtailed)
        latency = now - slot.t_admit
        self.stats.n_finished += 1
        self.stats.n_curtailed += int(curtailed)
        mreg = obs.metrics
        mreg.counter("serve_sched_evicted_total").inc()
        if curtailed:
            mreg.counter("serve_sched_curtailed_total").inc()
        mreg.histogram("serve_sched_request_latency_s",
                       sl=t.padded).observe(latency)
        # one EpochLog record per request, keyed by its padded SL: the
        # serving trace stays SeqPoint-summarizable under the scheduler
        eng.log.append(t.padded, latency,
                       tokens_out=float(slot.emitted),
                       ttft_s=float(slot.ttft_s),
                       queue_wait_s=slot.t_admit - t.t_submit,
                       curtailed=float(curtailed), sl_raw=float(t.sl))
        self._set_occupancy()

    def _set_occupancy(self) -> None:
        obs.metrics.gauge("serve_sched_slot_occupancy").set(
            len(self._active()) / self.engine.batch_size)

    def _curtail_deadline(self) -> None:
        eng = self.engine
        if eng.deadline_s is None:
            return
        now = eng._now()
        for i in self._active():
            slot = self.slots[i]
            if now - slot.t_admit > eng.deadline_s:
                obs.metrics.counter("serve_deadline_exceeded_total").inc()
                obs.event("serve_deadline", sl=slot.ticket.padded,
                          deadline_s=eng.deadline_s,
                          curtailed_tokens=slot.m_eff - slot.emitted)
                self._evict(i, curtailed=True)

    # -- the loop -------------------------------------------------------
    def run(self) -> ServeStats:
        """Drain the queue: admit / decode / evict until nothing is left.

        Every tick: curtail slots past their deadline, admit eligible
        requests into free slots (a full drain resets the position with a
        fresh wave), then run one shared decode step. Wall time and the
        running padding-waste gauge are committed into ``stats``.
        """
        eng = self.engine
        t0 = eng._now()
        while True:
            self._curtail_deadline()
            if not self._active():
                if not self.queue.depth():
                    break
                if self._admit(fresh=True) == 0:
                    raise RuntimeError(
                        f"admission policy {self.policy!r} admitted "
                        "nothing on a drained engine (would spin)")
                continue
            if self._free_slots() and self.queue.depth():
                self._admit(fresh=False)
            if not self._active():
                continue
            self._decode_once()
            obs.metrics.gauge("serve_sched_padding_waste").set(
                self.stats.padding_waste)
        self.stats.wall_s = eng._now() - t0
        obs.metrics.gauge("serve_sched_padding_waste").set(
            self.stats.padding_waste)
        obs.event("serve_sched_drain", **self.stats.summary())
        return self.stats


# --------------------------------------------------------------------------
# run-to-completion baseline with the same grid accounting


def run_to_completion(engine, requests) -> ServeStats:
    """Serve ``requests`` with plain FIFO ``run_batch`` chunks and account
    the same padded-grid cells the scheduler reports, so the two paths are
    directly comparable (the CI smoke job and the acceptance test diff
    their ``padding_waste`` / ``grid_throughput``)."""
    stats = ServeStats(n_requests=len(requests))
    t0 = engine._now()
    for c0 in range(0, len(requests), engine.batch_size):
        chunk = requests[c0:c0 + engine.batch_size]
        engine.run_batch(chunk)
        rec = engine.log.iterations[-1]
        width = int(rec.seq_len)
        calls = int(rec.stats["decode_steps"])
        stats.prefills += 1
        stats.prefill_cells += engine.batch_size * width
        stats.prefill_useful += sum(min(len(r.prompt), width)
                                    for r in chunk)
        stats.decode_steps += calls
        stats.decode_cells += calls * engine.batch_size
        stats.decode_useful += sum(max(0, len(r.output) - 1)
                                   for r in chunk)
        stats.tokens_out += int(rec.stats["tokens_out"])
        stats.n_finished += len(chunk)
        stats.n_curtailed += int(rec.stats.get("curtailed", 0.0))
        stats.admission_order.extend(range(c0, c0 + len(chunk)))
    stats.wall_s = engine._now() - t0
    return stats
