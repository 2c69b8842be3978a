"""Training loop: auto-resume, async checkpoints, straggler detection,
SeqPoint epoch logging as a first-class hook — hardened for fleet faults
(a port of ``repro.train.trainer``).

The trainer logs every iteration's (padded SL, wallclock) into an
``EpochLog`` — after one epoch, ``seqpoints()`` hands back the
representative iterations, which is how a fleet user would profile a new
hardware/software config for this exact (model, dataset, batch-size)
combination without re-running the epoch (paper §V-C step 1 integrated at
the point the data already flows).

That projection is only trustworthy if the log survives real fleet
conditions, so the step loop is wrapped in a recovery ladder
(``repro_torch.resilience``):

* transient data/checkpoint faults retry with backoff;
* a NaN/inf or diverging loss rolls back to the last good checkpoint —
  restoring params, optimizer, data-iterator position *and* the partial
  EpochLog — and a batch that fails repeatedly is skipped as poison;
* a preemption writes an emergency checkpoint pointing at the interrupted
  batch, so the resumed process replays it and the stitched EpochLog (and
  hence ``select_seqpoints``) matches the fault-free run bit-for-bit;
* a confirmed peer loss (``resilience.elastic``) checkpoints, shrinks the
  mesh over the surviving hosts, restores the state onto it, and resumes
  in-process — the fourth recovery tier;
* a per-SL running-median watchdog flags stragglers (and injected ones).

The model owns its weights: the trainer trains them in place and never
draws new ones, so a second ``train()`` without a checkpoint continues from
the weights the first one left (with fresh optimizer moments). A step's
time runs from the start of the step function to the end of a
``torch.cuda.synchronize()`` on a card (the span
``train/block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.core.profile import EpochLog
from repro_torch.core.seqpoint import SeqPointSet, select_seqpoints
from repro_torch.data.batching import DataIterator
from repro_torch.dist.compression import dp_grad_wire_bytes
from repro_torch.dist.sharding import tp_activation_wire_bytes
from repro_torch.models.model_zoo import Model
from repro_torch.resilience import elastic, faults
from repro_torch.resilience.elastic import ClusterMonitor, PeerLossFault
from repro_torch.resilience.faults import PreemptionFault, TransientFault
from repro_torch.resilience.guards import (
    DivergenceDetector,
    GuardViolation,
    StepTimeWatchdog,
    check_finite,
)
from repro_torch.resilience.recovery import (
    BatchSkipList,
    RecoveryPolicy,
    pack_train_extra,
    retry_with_backoff,
    unpack_train_extra,
)
from repro_torch.train.train_step import (
    TrainState,
    assign_state,
    build_train_step,
    init_train_state,
)


@dataclass
class TrainerReport:
    steps: int = 0
    resumed_from: Optional[int] = None
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    stragglers: int = 0
    epoch_log: Optional[EpochLog] = None
    # resilience accounting
    preempted: bool = False          # train() returned early; resume to finish
    rollbacks: int = 0
    guard_violations: int = 0
    skipped_batches: int = 0
    remeshes: int = 0                # tier-4 elastic re-meshes taken
    lost_hosts: list = field(default_factory=list)


class Trainer:
    def __init__(self, model: Model, run: RunConfig, data: DataIterator, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 straggler_factor: float = 3.0, total_steps: int = 1000,
                 policy: Optional[RecoveryPolicy] = None,
                 cluster: Optional[ClusterMonitor] = None,
                 timer: Callable[[], float] = time.perf_counter):
        self.model = model
        self.run = run
        self.data = data
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.policy = policy or RecoveryPolicy()
        self.cluster = cluster or ClusterMonitor.from_mesh(run.mesh)
        self.skiplist = BatchSkipList(
            skip_after=self.policy.skip_after_failures)
        self.timer = timer
        self.watchdog = StepTimeWatchdog(factor=straggler_factor)
        self.divergence = DivergenceDetector(
            ratio=self.policy.divergence_ratio,
            patience=self.policy.divergence_patience)
        self.step_fn = build_train_step(model, run, total_steps)
        self.epoch_log = EpochLog(meta={"model": run.model.name})

    # ------------------------------------------------------------------
    def _extra(self, step: int) -> dict:
        return pack_train_extra(step, self.data.state(), self.epoch_log,
                                self.skiplist)

    def _retry(self, fn, label: str):
        return retry_with_backoff(
            fn, retries=self.policy.max_retries,
            base_delay=self.policy.backoff_base_s,
            factor=self.policy.backoff_factor,
            max_delay_s=self.policy.max_delay_s,
            jitter_frac=self.policy.jitter_frac,
            jitter_seed=self.policy.jitter_seed, label=label)

    def _restore(self, state: TrainState, **kw) -> Tuple[TrainState, dict]:
        restored, extra = self._retry(
            lambda: self.ckpt.restore(state, **kw), label="ckpt_restore")
        return assign_state(state, restored), extra

    def init_or_resume(self) -> Tuple[TrainState, int]:
        state = init_train_state(self.model, self.run)
        start = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, extra = self._restore(state)
            start, data_state, log, skip_state = unpack_train_extra(extra)
            if data_state is not None:
                self.data.restore(data_state)
            if log is not None:
                self.epoch_log = log
            # a poison batch stays poison across process restarts — the
            # resumed process must not pay the discovery rollbacks again
            self.skiplist.restore(skip_state)
        return state, start

    def _comm_profile(self, state: TrainState) -> Tuple[int, int, float]:
        """(dp_degree, tp_degree, per-step DP grad wire bytes) for the
        *current* mesh — recomputed after an elastic re-mesh shrinks DP."""
        dp_deg = self.run.mesh.num_devices \
            if self.run.parallelism == "dp_only" else self.run.mesh.data_degree
        tp_deg = self.run.mesh.model_degree \
            if self.run.parallelism == "tp" else 1
        dp_bytes = dp_grad_wire_bytes(
            state.params, self.run.optimizer.grad_compression, dp_deg)
        return dp_deg, tp_deg, dp_bytes

    def _batch(self, tokens, labels) -> Dict[str, torch.Tensor]:
        dev = self.model.device
        return {"tokens": torch.as_tensor(tokens, dtype=torch.long,
                                          device=dev),
                "labels": torch.as_tensor(labels, dtype=torch.long,
                                          device=dev)}

    # ------------------------------------------------------------------
    def train(self, num_steps: int) -> TrainerReport:
        state, start = self.init_or_resume()
        report = TrainerReport(resumed_from=start or None)
        it: Iterator = iter(self.data)
        # per-step DP gradient wire bytes are SL-independent (one param-sized
        # all-reduce); TP activation bytes scale with SL — both go into
        # EpochLog.stats so SeqPoint projects communication alongside compute
        dp_deg, tp_deg, dp_bytes = self._comm_profile(state)
        obs.event("train_start", model=self.run.model.name, start_step=start,
                  num_steps=num_steps, dp_degree=dp_deg, tp_degree=tp_deg)
        mreg = obs.metrics
        skiplist = self.skiplist
        rollbacks = 0
        end = start + num_steps
        step = start
        on_card = self.model.device.type == "cuda"
        # rollback safety net: guarantee a restorable checkpoint exists
        # before the first optimizer step can fail
        if self.ckpt is not None and self.ckpt.latest_step() is None:
            self._retry(lambda: self.ckpt.save(start, state,
                                               extra=self._extra(start)),
                        label="ckpt_save")
            obs.event("checkpoint", step=start, mode="initial")
        while step < end:
            # iterator position BEFORE the fetch: the identity of the batch
            # about to run, and the resume point if this step is preempted
            pre_fetch = self.data.state()
            batch_key = (pre_fetch["epoch"], pre_fetch["batch_index"])
            if skiplist.should_skip(batch_key):
                next(it)                              # discard poison batch
                report.skipped_batches += 1
                mreg.counter("train_skipped_batches_total").inc()
                obs.event("poison_batch_skipped", step=step,
                          epoch=batch_key[0], batch_index=batch_key[1])
                continue
            try:
                # heartbeat interval: raises PeerLossFault once the tracker
                # confirms a host lost (tier-4 re-mesh arm below)
                self.cluster.pulse(step)
                with obs.span("train/step", step=step) as step_span:
                    with obs.span("train/data_fetch"):
                        def fetch():
                            faults.fire("data_fetch", step)
                            return next(it)
                        tokens, labels, sl = self._retry(fetch,
                                                         label="data_fetch")
                        batch = self._batch(tokens, labels)
                    step_span.set(sl=sl)
                    faults.fire("preempt", step)
                    t0 = self.timer()
                    with obs.span("train/step_fn", sl=sl):
                        state, metrics = self.step_fn(state, batch)
                    with obs.span("train/block_until_ready"):
                        if on_card:
                            torch.cuda.synchronize()
                    dt = self.timer() - t0
                    dt += faults.delay("straggler", step)
                    loss = faults.corrupt("nan_loss", step,
                                          float(metrics["loss"]))
                    check_finite(loss, name="loss", step=step)
                    if self.policy.check_grads and "grad_norm" in metrics:
                        check_finite(float(metrics["grad_norm"]),
                                     name="grad_norm", step=step)
                    self.divergence.update(loss, step=step)
            except PreemptionFault:
                return self._handle_preemption(step, start, state,
                                               pre_fetch, report)
            except PeerLossFault as e:
                mreg.counter("train_peer_losses_total").inc(len(e.hosts))
                obs.event("peer_lost", step=step, hosts=sorted(e.hosts),
                          tick=e.tick)
                if self.ckpt is None \
                        or report.remeshes >= self.policy.max_remeshes:
                    raise
                state, step = self._remesh(e, step, start, state,
                                           pre_fetch, report)
                dp_deg, tp_deg, dp_bytes = self._comm_profile(state)
                it = iter(self.data)  # regenerate from restored position
                continue
            except GuardViolation as e:
                report.guard_violations += 1
                mreg.counter("train_guard_violations_total").inc()
                obs.event("guard_violation", step=step, error=str(e),
                          epoch=batch_key[0], batch_index=batch_key[1])
                if self.ckpt is None or rollbacks >= self.policy.max_rollbacks:
                    raise
                rollbacks += 1
                report.rollbacks += 1
                now_poison = skiplist.record_failure(batch_key)
                # the step updated the state in place: the checkpoint
                # restores every tensor of it
                state, step = self._rollback(state, start, report,
                                             poison=now_poison)
                it = iter(self.data)      # regenerate from restored position
                continue
            # -- step accepted ------------------------------------------
            verdict = self.watchdog.observe(sl, dt)
            if verdict.is_straggler:
                report.stragglers += 1
                mreg.counter("train_stragglers_total").inc()
                obs.event("straggler", step=step, sl=sl, dt=dt,
                          baseline=verdict.baseline,
                          factor=self.watchdog.factor)
            report.losses.append(loss)
            report.step_times.append(dt)
            tp_bytes = tp_activation_wire_bytes(
                self.run.model, self.run.shape.global_batch, sl, tp_deg)
            self.epoch_log.append(sl, dt, dp_wire_bytes=dp_bytes,
                                  tp_wire_bytes=tp_bytes)
            mreg.counter("train_steps_total").inc()
            mreg.histogram("train_step_time_s", sl=sl).observe(dt)
            mreg.histogram("train_padded_sl").observe(sl)
            mreg.gauge("train_dp_wire_bytes").set(dp_bytes)
            mreg.histogram("train_tp_wire_bytes", sl=sl).observe(tp_bytes)
            step += 1
            if self.ckpt is not None and step % self.ckpt_every == 0:
                self._save_periodic(step, state)
        if self.ckpt is not None:
            with obs.span("train/checkpoint_final", step=end):
                self._wait_ckpt()
                self._retry(lambda: self.ckpt.save(end, state,
                                                   extra=self._extra(end)),
                            label="ckpt_save")
            obs.event("checkpoint", step=end, mode="final")
        report.steps = num_steps
        report.epoch_log = self.epoch_log
        obs.event("train_end", steps=num_steps, stragglers=report.stragglers,
                  rollbacks=report.rollbacks,
                  skipped_batches=report.skipped_batches,
                  total_runtime=self.epoch_log.total_runtime)
        return report

    # ------------------------------------------------------------------
    def _wait_ckpt(self) -> None:
        """Drain the async writer; a surfaced background failure must not
        abort recovery (the event is already emitted at capture time)."""
        try:
            self.ckpt.wait()
        except (TransientFault, OSError):
            pass

    def _save_periodic(self, step: int, state: TrainState) -> None:
        with obs.span("train/checkpoint_async", step=step):
            try:
                self.ckpt.save_async(step, state, extra=self._extra(step))
            except (TransientFault, OSError) as e:
                # either the previous background write failed (surfaced by
                # save_async's wait) or the snapshot itself did — fall back
                # to a synchronous retried save so the rollback target
                # stays fresh
                obs.event("ckpt_save_error", step=step, error=repr(e))
                self._retry(lambda: self.ckpt.save(step, state,
                                                   extra=self._extra(step)),
                            label="ckpt_save")
        obs.event("checkpoint", step=step, mode="async")

    def _rollback(self, state: TrainState, start: int, report: TrainerReport,
                  *, poison: bool) -> Tuple[TrainState, int]:
        """Restore the last good checkpoint (params, opt, iterator position,
        partial EpochLog) and truncate the report to match."""
        with obs.span("train/rollback"):
            self._wait_ckpt()
            state, extra = self._restore(state, fallback=True)
            # NOTE: the skip list is deliberately NOT restored here — the
            # checkpoint predates the failures just recorded, and merging
            # an older snapshot must never undo in-memory poison status
            ckpt_step, data_state, log, _ = unpack_train_extra(extra)
            if data_state is not None:
                self.data.restore(data_state)
            if log is not None:
                self.epoch_log = log
            done = max(ckpt_step - start, 0)
            del report.losses[done:]
            del report.step_times[done:]
            self.divergence.reset()
        obs.metrics.counter("train_rollbacks_total").inc()
        obs.event("rollback", to_step=ckpt_step, poison_batch=poison)
        return state, ckpt_step

    def _remesh(self, e: PeerLossFault, step: int, start: int,
                state: TrainState, pre_fetch_state: Dict[str, int],
                report: TrainerReport) -> Tuple[TrainState, int]:
        """Tier 4: elastic re-mesh after a confirmed peer loss.

        Checkpoint (pinned at the batch about to run), shrink the mesh's
        data axis past the dead hosts, restore onto the survivors, and
        resume in-process. The restored iterator position and partial
        EpochLog make the replayed steps re-log identical (sl, runtime)
        records, so SeqPoint selection survives the shrink; only the
        communication stats (dp_wire_bytes) change with the smaller DP
        degree, as they physically must.
        """
        lost = sorted(set(e.hosts) | self.cluster.dead_hosts)
        with obs.span("train/remesh", step=step, lost=lost):
            # pin the survivors' state before touching the mesh: if the
            # shrink itself fails we can still resume from here
            self._wait_ckpt()
            extra = pack_train_extra(step, pre_fetch_state, self.epoch_log,
                                     self.skiplist)
            self._retry(lambda: self.ckpt.save(step, state, extra=extra),
                        label="ckpt_save")
            obs.event("checkpoint", step=step, mode="remesh")
            # shrink: raises ClusterFailure when nothing survives
            new_mesh, _ = self.cluster.domains.surviving_mesh(lost)
            self.cluster = self.cluster.after_loss(e.hosts)
            self.run = dataclasses.replace(self.run, mesh=new_mesh)
            state, extra = self._restore(state, fallback=True)
            ckpt_step, data_state, log, skip_state = unpack_train_extra(extra)
            if data_state is not None:
                self.data.restore(data_state)
            if log is not None:
                self.epoch_log = log
            self.skiplist.restore(skip_state)
            state, n_sharded = elastic.reshard_state(state, self.run)
            done = max(ckpt_step - start, 0)
            del report.losses[done:]
            del report.step_times[done:]
            self.divergence.reset()
        report.remeshes += 1
        report.lost_hosts.extend(lost)
        mreg = obs.metrics
        mreg.counter("train_remeshes_total").inc()
        mreg.gauge("cluster_healthy_hosts").set(len(self.cluster.hosts))
        mreg.gauge("train_dp_degree").set(new_mesh.data_degree)
        obs.event("remesh", step=ckpt_step, lost_hosts=lost,
                  new_shape=list(new_mesh.shape),
                  data_degree=new_mesh.data_degree,
                  surviving_hosts=list(self.cluster.hosts),
                  resharded_params=n_sharded)
        return state, ckpt_step

    def _handle_preemption(self, step: int, start: int, state: TrainState,
                           pre_fetch_state: Dict[str, int],
                           report: TrainerReport) -> TrainerReport:
        """Graceful drain on preemption: emergency checkpoint pointing at
        the interrupted batch, then hand back a partial report. A fresh
        Trainer resumes at exactly this batch and the stitched run is
        indistinguishable from an uninterrupted one."""
        report.preempted = True
        report.steps = step - start
        report.epoch_log = self.epoch_log
        obs.metrics.counter("train_preemptions_total").inc()
        if self.ckpt is not None:
            with obs.span("train/checkpoint_preempt", step=step):
                self._wait_ckpt()
                extra = pack_train_extra(step, pre_fetch_state,
                                         self.epoch_log, self.skiplist)
                self._retry(lambda: self.ckpt.save(step, state, extra=extra),
                            label="ckpt_save")
            obs.event("checkpoint", step=step, mode="preempt")
        obs.event("preempted", step=step, completed=step - start,
                  can_resume=self.ckpt is not None)
        return report

    def seqpoints(self, **kw) -> SeqPointSet:
        return select_seqpoints(self.epoch_log, **kw)
