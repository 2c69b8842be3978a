"""Minimal batched serving engine: prefill + greedy decode over a request
queue with a fixed-shape KV cache (a port of ``repro.serve.engine``).

SeqPoint's insight applies at serving too (paper §VII-E): per-request
prefill cost is keyed by prompt SL, so the engine logs (SL, prefill
latency) — with decode time, decode-call count, emitted-token and batch
latency stats on the same record — and ``seqpoints()`` summarizes a serving
trace the same way training epochs are summarized.

Request hedging (tail-latency defense): with ``n_replicas > 1`` the engine
tracks a per-SL running median of past batch latencies
(``StepTimeWatchdog``); when an in-flight batch runs ``hedge_factor``× past
that baseline — detected between decode steps — it is speculatively
re-issued on the next-healthiest simulated replica. First (virtual)
finisher wins; the loser's tokens are discarded, never reaching the caller
or the ``tokens_out`` counter, and the slow replica takes a health strike.
Slowness is injected via the ``peer_slow`` fault point as a *virtual*
per-decode-call penalty keyed by a per-execution index, so the hedge
re-execution (a different index) never inherits the primary's injected
delay and chaos replays stay deterministic.

On a CUDA card the model's hand-written kernels (flash attention in every
attention prefill, WKV6 in every rwkv prefill and decode step) are built
when the model was placed on the card, so compile time never lands in a
prefill latency or in the hedging baseline. Each timed phase ends in a
device synchronize. Decode writes K/V, or an rwkv layer's shift and state,
into the serving cache in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPointSet, select_seqpoints
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model_zoo import Model
from repro_torch.resilience import faults
from repro_torch.resilience.elastic import ReplicaSet
from repro_torch.resilience.guards import StepTimeWatchdog
from repro_torch.resilience.recovery import RecoveryPolicy, retry_with_backoff


@dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    output: List[int] = field(default_factory=list)
    shed: bool = False            # dropped on overload, never ran
    curtailed: bool = False       # deadline hit mid-decode: partial output


class ServeEngine:
    def __init__(self, model: Model, *, batch_size: int = 4,
                 max_len: int = 512, sl_granularity: int = 32,
                 deadline_s: Optional[float] = None,
                 n_replicas: int = 1, hedge_factor: float = 3.0,
                 policy: Optional[RecoveryPolicy] = None,
                 timer: Optional[Callable[[], float]] = None,
                 device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model is on {model.device}, engine asked "
                             f"for {dev}")
        self.device = model.device
        self.model = model
        self.batch_size = batch_size
        self.max_len = max_len
        self.gran = sl_granularity
        self.deadline_s = deadline_s
        self.hedge_factor = hedge_factor
        self.policy = policy or RecoveryPolicy()
        self.replicas = ReplicaSet(n_replicas)
        # injectable clock: tests pass a FakeClock so every latency, TTFT,
        # and deadline decision is bit-identical across runs
        self._now = timer or time.perf_counter
        # per-SL running median of past batch latencies: the hedge baseline
        self.latency_watchdog = StepTimeWatchdog(factor=hedge_factor)
        self._prefill = model.prefill
        self._decode = model.decode_step
        self._decode_calls = 0
        self._exec_index = 0          # one per batch execution (hedges too)
        self.log = EpochLog(meta={"kind": "serve"})

    def _pad(self, sl: int) -> int:
        return min(self.max_len, -(-sl // self.gran) * self.gran)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(toks, dtype=torch.long, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _execute(self, batch: List[Request], n_admitted: int,
                 toks: np.ndarray, sl: int, batch_t0: float,
                 hedge_cutoff_s: Optional[float]) -> Dict:
        """Run one prefill+decode execution of the batch on one replica.

        Never mutates the ``Request`` objects: generated tokens go into
        local per-row lists and the caller commits only the winning
        execution's outputs. Returns prefill/decode timings, the emitted
        count, the *virtual* batch latency (real elapsed plus any injected
        ``peer_slow`` per-decode-call penalty), and ``hedge_at`` — the
        virtual elapsed time at which the batch crossed ``hedge_cutoff_s``
        (None when it never did or no cutoff was armed).

        The real deadline clock (``batch_t0``) is shared across hedged
        executions: a hedge spends the same SLO budget the primary already
        burned. Injected slowness is virtual and does not consume it.
        """
        mreg = obs.metrics
        exec_index = self._exec_index
        self._exec_index += 1
        # a peer_slow spec firing at this execution degrades every decode
        # call of this execution (slow link), consuming the spec's budget so
        # a hedge re-execution at the next index runs at full speed
        spec = faults.check("peer_slow", exec_index)
        penalty_per_call = float(spec.delay) if spec is not None else 0.0
        penalty = 0.0
        hedge_at: Optional[float] = None
        deadline_hit = False
        exec_t0 = self._now()
        with obs.span("serve/prefill", sl=sl, batch=n_admitted):
            logits, caches = self._prefill({"tokens": self._tokens(toks)})
            self._sync()
        prefill_dt = self._now() - exec_t0
        mreg.histogram("serve_prefill_s", sl=sl).observe(prefill_dt)

        # decode greedily; caches from prefill hold exactly sl entries, so
        # copy them into the front of the fixed-size serving cache
        full = self.model.init_cache(self.batch_size, self.max_len,
                                     prefix=caches)
        token = logits[:, -1].argmax(dim=-1)[:, None]
        tok_host = token[:, 0].tolist()
        n_steps = max((r.max_new_tokens for r in batch), default=0)
        dec_t0 = self._now()
        outputs: List[List[int]] = [[] for _ in batch]
        emitted = 0                       # tokens bound for real requests
        decode_calls = 0
        for step in range(n_steps):
            for i, r in enumerate(batch):
                if step < r.max_new_tokens:
                    outputs[i].append(int(tok_host[i]))
                    if i < n_admitted:
                        emitted += 1
            if step + 1 >= n_steps:       # final token came from the last
                break                     # decode (or prefill) — done
            if self.deadline_s is not None and \
                    self._now() - batch_t0 > self.deadline_s:
                curtailed = sum(
                    max(0, r.max_new_tokens - len(outputs[i]))
                    for i, r in enumerate(batch) if i < n_admitted)
                deadline_hit = True
                mreg.counter("serve_deadline_exceeded_total").inc()
                obs.event("serve_deadline", sl=sl,
                          deadline_s=self.deadline_s,
                          curtailed_tokens=curtailed)
                break
            if hedge_at is None and hedge_cutoff_s is not None:
                virtual = self._now() - exec_t0 + penalty
                if virtual > hedge_cutoff_s:
                    hedge_at = virtual
            t1 = self._now()
            with obs.span("serve/decode_token", pos=sl + step):
                def decode_once():
                    faults.fire("decode", self._decode_calls)
                    return self._decode(full, token, sl + step)
                logits, full = retry_with_backoff(
                    decode_once, retries=self.policy.max_retries,
                    base_delay=self.policy.backoff_base_s,
                    factor=self.policy.backoff_factor,
                    max_delay_s=self.policy.max_delay_s,
                    jitter_frac=self.policy.jitter_frac,
                    jitter_seed=self.policy.jitter_seed,
                    label="serve_decode")
                self._decode_calls += 1
                decode_calls += 1
                penalty += penalty_per_call
                token = logits.argmax(dim=-1)[:, None]
                tok_host = token[:, 0].tolist()     # synchronizes
            mreg.histogram("serve_decode_token_s", sl=sl).observe(
                self._now() - t1)
        decode_dt = self._now() - dec_t0 if n_steps else 0.0
        latency = self._now() - exec_t0 + penalty
        if hedge_at is None and hedge_cutoff_s is not None \
                and latency > hedge_cutoff_s:
            hedge_at = latency            # crossed after the last decode
        return {"outputs": outputs, "emitted": emitted,
                "decode_calls": decode_calls, "prefill_dt": prefill_dt,
                "decode_dt": decode_dt, "latency_s": latency,
                "penalty_s": penalty, "hedge_at": hedge_at,
                "deadline_hit": deadline_hit}

    # ------------------------------------------------------------------
    def run_batch(self, requests: List[Request]) -> List[Request]:
        """Prefill a batch of same-padded-SL requests, then decode.

        Pads the batch with dummy requests on a local copy only; the
        caller's list is never mutated and only the real requests are
        returned. Each prompt is right-aligned in a zero-filled row and the
        pad positions are attended with no padding mask, as in the
        reference. Prefill's last-position logits supply the first
        generated token, so ``n_steps`` useful tokens cost ``n_steps - 1``
        decode calls.

        Overload sheds instead of crashing: requests beyond ``batch_size``
        come back with ``shed=True`` and empty output for the caller to
        requeue. With ``deadline_s`` set, decode stops once the batch has
        used its budget (prefill included) and the remaining tokens are
        curtailed — latency SLO over completion; curtailed requests carry
        ``curtailed=True`` and the serve EpochLog records the count, so a
        partial answer is never mistaken for a completed one. Transient
        decode faults are retried with backoff (the injected ones fire
        before the decode call, so no cache state is lost). With
        ``n_replicas > 1`` a batch running ``hedge_factor``× past its
        per-SL median baseline is hedged onto another replica; only the
        winning execution's tokens are committed and counted.

        Batch formation is delegated to the scheduler layer (an
        ``AdmissionQueue`` + ``FifoPolicy`` one-shot): this method is the
        run-to-completion compatibility wrapper around the same admission
        machinery the continuous ``serve()`` loop uses.
        """
        from repro_torch.serve.sched.policy import FifoPolicy
        from repro_torch.serve.sched.queue import AdmissionQueue

        mreg = obs.metrics
        mreg.gauge("serve_queue_depth").set(len(requests))
        q = AdmissionQueue(self.max_len, timer=self._now)
        tickets = {id(r): q.submit(r) for r in requests}
        picked = FifoPolicy().select(q.pending(), self.batch_size)
        q.take(picked)
        admitted = [t.req for t in picked]
        for r in requests:                                # shed-on-overload
            r.shed = tickets[id(r)] not in picked
        n_shed = len(requests) - len(admitted)
        if n_shed:
            mreg.counter("serve_shed_total").inc(n_shed)
            obs.event("serve_shed", count=n_shed, admitted=len(admitted))
        mreg.gauge("serve_batch_fill").set(len(admitted) / self.batch_size)
        batch_t0 = self._now()                            # deadline clock
        batch = list(admitted)
        while len(batch) < self.batch_size:               # pad batch
            batch.append(Request(prompt=np.zeros(4, np.int32),
                                 max_new_tokens=0))
        sl = self._pad(max(len(r.prompt) for r in batch))
        toks = np.zeros((self.batch_size, sl), np.int32)
        real_tokens = 0
        for i, r in enumerate(batch):
            prompt = r.prompt[-sl:]       # keep the most recent sl tokens
            if len(prompt):
                toks[i, -len(prompt):] = prompt
            if i < len(admitted):
                real_tokens += len(prompt)
        # fraction of the (batch, sl) prefill grid that is dummy/pad work
        waste = 1.0 - real_tokens / float(self.batch_size * sl)
        mreg.gauge("serve_padding_waste").set(waste)
        mreg.histogram("serve_padding_waste_frac", sl=sl).observe(waste)

        primary = self.replicas.pick_primary()
        baseline = self.latency_watchdog.baseline(sl)
        cutoff = self.hedge_factor * baseline \
            if baseline is not None and self.replicas.n > 1 else None
        result = self._execute(batch, len(admitted), toks, sl, batch_t0,
                               cutoff)
        winner, hedged = primary, False
        if result["hedge_at"] is not None:
            hedge_replica = self.replicas.pick_hedge(exclude=primary)
            mreg.counter("serve_hedges_total").inc()
            obs.event("hedge_fired", sl=sl, primary=primary,
                      hedge_replica=hedge_replica,
                      at_s=result["hedge_at"], baseline_s=baseline,
                      factor=self.hedge_factor)
            hedge = self._execute(batch, len(admitted), toks, sl, batch_t0,
                                  None)
            # the hedge starts at the detection instant, so its virtual
            # finish line is detection time + its own latency
            hedge_total = result["hedge_at"] + hedge["latency_s"]
            if hedge_total < result["latency_s"]:
                self.replicas.mark_slow(primary)
                self.replicas.mark_ok(hedge_replica)
                mreg.counter("serve_hedge_wins_total").inc()
                obs.event("hedge_won", sl=sl, winner=hedge_replica,
                          latency_s=hedge_total,
                          primary_latency_s=result["latency_s"])
                obs.event("hedge_cancelled", sl=sl, loser=primary,
                          wasted_tokens=result["emitted"])
                hedge["latency_s"] = hedge_total
                result, winner, hedged = hedge, hedge_replica, True
            else:
                self.replicas.mark_ok(primary)
                obs.event("hedge_cancelled", sl=sl, loser=hedge_replica,
                          wasted_tokens=hedge["emitted"])
        else:
            self.replicas.mark_ok(primary)

        # commit the winning execution only: the loser's tokens never reach
        # the caller or the tokens_out counter
        n_curtailed = 0
        for i, r in enumerate(admitted):
            r.output.extend(result["outputs"][i])
            r.curtailed = bool(result["deadline_hit"]
                               and len(r.output) < r.max_new_tokens)
            n_curtailed += int(r.curtailed)
        if n_curtailed:
            mreg.counter("serve_curtailed_total").inc(n_curtailed)
        latency = result["latency_s"]
        self.latency_watchdog.observe(sl, latency)
        mreg.histogram("serve_batch_latency_s", sl=sl).observe(latency)
        # tokens_out counts tokens actually emitted to real requests — not
        # requested tokens summed over the padded batch — so serve
        # throughput metrics stay honest under shedding, deadlines, and
        # hedging; curtailed distinguishes deadline-cut partials from
        # completed requests
        self.log.append(sl, result["prefill_dt"],
                        decode_s=result["decode_dt"],
                        decode_steps=float(result["decode_calls"]),
                        tokens_out=float(result["emitted"]),
                        latency_s=latency, hedged=float(hedged),
                        curtailed=float(n_curtailed),
                        replica=float(winner))
        return requests

    # ------------------------------------------------------------------
    def serve(self, requests: List[Request], *, policy=None,
              max_queue: Optional[int] = None):
        """Serve ``requests`` through the SL-aware continuous-batching
        scheduler (``repro_torch.serve.sched``): SL-bucketed admission,
        slot admission at decode-step granularity, immediate eviction of
        finished sequences. Returns the run's ``ServeStats``.

        ``policy`` is any ``sched.policy.AdmissionPolicy`` (default:
        bucket-affine). Per-request log records land in ``self.log`` (one
        per request, keyed by its padded SL), so ``seqpoints()`` works on
        a scheduled trace exactly as on a run-to-completion one.
        """
        from repro_torch.serve.sched.loop import ContinuousBatcher

        batcher = ContinuousBatcher(self, policy=policy,
                                    max_queue=max_queue)
        for r in requests:
            batcher.submit(r)
        with torch.inference_mode():
            return batcher.run()

    def seqpoints(self, **kw) -> SeqPointSet:
        return select_seqpoints(self.log, **kw)
