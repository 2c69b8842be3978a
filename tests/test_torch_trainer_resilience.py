"""The port's Trainer under faults: the trainer scenarios of
``tests/test_system.py`` and ``tests/test_resilience.py`` (rollback on NaN,
poison-batch skips, retries, preemption + resume under a FakeClock with a
corrupt emergency checkpoint, stragglers, divergence, the tier-4 re-mesh,
the skip list across a restart) on the tiny starcoder2-3b config in
float32, with the assertions the reference's tests make; and the new
resilience pieces (guards, skip list, checkpoint extras, failure domains,
peer health, the cluster monitor) held to the reference's on the same
inputs. Resuming within the port is bitwise: losses and logs are compared
for equality."""
import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.configs import MeshConfig as JaxMeshConfig
from repro.core.profile import EpochLog as JaxEpochLog
from repro.resilience import elastic as jelastic
from repro.resilience import faults as jfaults
from repro.resilience import guards as jguards
from repro.resilience import recovery as jrecovery
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro_torch import obs
from repro_torch.configs import (
    MeshConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
    smoke_config,
)
from repro_torch.configs import get_model_config
from repro_torch.core.profile import EpochLog
from repro_torch.data.batching import DataIterator
from repro_torch.data.synthetic import IWSLT_LIKE
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime
from repro_torch.resilience import (
    BatchSkipList,
    ClusterFailure,
    ClusterMonitor,
    DivergenceDetector,
    DivergenceError,
    FailureDomains,
    FaultPlan,
    NonFiniteLossError,
    PeerHealthTracker,
    PeerLossFault,
    PreemptionFault,
    RecoveryPolicy,
    TransientFault,
    check_finite,
    faults,
    pack_train_extra,
    reshard_state,
    unpack_train_extra,
)
from repro_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def _no_global_faults():
    """Each test owns the global plans (the port's and the reference's)."""
    prev, jprev = faults.install(None), jfaults.install(None)
    yield
    faults.install(prev)
    jfaults.install(jprev)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny model's ops are microseconds: threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256)


def _tiny_run(mesh_shape=(1,), mesh_axes=("data",)):
    cfg = smoke_config("starcoder2-3b").with_overrides(**TINY)
    shape = ShapeConfig("tiny", seq_len=32, global_batch=8,
                        step=StepKind.TRAIN)
    mesh = MeshConfig(shape=mesh_shape, axes=mesh_axes)
    run = RunConfig(model=cfg, shape=shape, mesh=mesh,
                    optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2),
                    param_dtype="float32", compute_dtype="float32")
    return cfg, run


def _data(cfg):
    return DataIterator(IWSLT_LIKE, samples_per_epoch=256, batch_size=8,
                        vocab_size=cfg.vocab_size, granularity=8, seed=1)


class FakeClock:
    """Deterministic timer: one tick per call, so every measured step takes
    exactly 1.0 'seconds' and runtimes are bit-identical across runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _make_trainer(ckpt_dir=None, *, ckpt_every=4, total=16, timer=None,
                  policy=None, mesh_shape=(1,), **kw):
    cfg, run = _tiny_run(mesh_shape=mesh_shape)
    model = build_model(cfg, Runtime.from_run(run), device="cpu", seed=0)
    if timer is not None:
        kw["timer"] = timer
    return Trainer(model, run, _data(cfg),
                   ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                   ckpt_every=ckpt_every, total_steps=total,
                   policy=policy or RecoveryPolicy(backoff_base_s=0.0), **kw)


# -------------------------------------------------------------------------
# tests/test_system.py's trainer scenarios


def test_trainer_loss_decreases_and_logs_sls():
    tr = _make_trainer(total=40)
    report = tr.train(30)
    assert report.steps == 30
    assert np.mean(report.losses[:5]) > np.mean(report.losses[-5:])
    assert tr.epoch_log.num_iterations == 30
    sp = tr.seqpoints(error_threshold=0.1)
    assert sp.num_points >= 1
    assert np.isclose(sp.weights.sum(), 30)


def test_trainer_resume_is_bitwise(tmp_path):
    rep_full = _make_trainer(tmp_path / "full", ckpt_every=5,
                             total=40).train(10)
    _make_trainer(tmp_path / "cut", ckpt_every=5, total=40).train(5)
    t_b = _make_trainer(tmp_path / "cut", ckpt_every=5, total=40)
    rep_b = t_b.train(5)
    assert rep_b.resumed_from == 5
    assert rep_full.losses[5:] == rep_b.losses


def test_straggler_counter():
    tr = _make_trainer(straggler_factor=1e-9, total=10)
    rep = tr.train(6)
    assert rep.stragglers >= 4            # every step beyond the first few


# -------------------------------------------------------------------------
# tests/test_resilience.py's trainer chaos paths


def test_nan_loss_triggers_rollback_and_training_converges(tmp_path):
    faults.install(FaultPlan.parse("nan_loss@5"))
    tr = _make_trainer(tmp_path / "ck")
    rep = tr.train(12)
    assert rep.rollbacks == 1 and rep.guard_violations == 1
    assert rep.steps == 12 and len(rep.losses) == 12
    assert all(np.isfinite(rep.losses))              # poisoned step replayed
    assert np.mean(rep.losses[:4]) > np.mean(rep.losses[-4:])
    assert tr.epoch_log.num_iterations == 12


def test_persistent_nan_skips_poison_batch(tmp_path):
    faults.install(FaultPlan.parse("nan_loss@5:times=2"))
    tr = _make_trainer(tmp_path / "ck")
    rep = tr.train(10)
    assert rep.rollbacks == 2
    assert rep.skipped_batches == 1
    assert rep.steps == 10 and len(rep.losses) == 10
    assert all(np.isfinite(rep.losses))


def test_guard_violation_without_ckpt_raises():
    faults.install(FaultPlan.parse("nan_loss@2"))
    tr = _make_trainer()                             # no ckpt_dir: no net
    with pytest.raises(NonFiniteLossError):
        tr.train(5)


def test_data_fetch_fault_is_retried_transparently(tmp_path):
    faults.install(FaultPlan.parse("data_fetch@3"))
    tr = _make_trainer(tmp_path / "ck")
    rep = tr.train(8)
    assert rep.steps == 8 and len(rep.losses) == 8
    assert rep.rollbacks == 0                        # retry, not rollback


@pytest.fixture(scope="module")
def fault_free(tmp_path_factory):
    """A fault-free 12-step run under the FakeClock."""
    tr = _make_trainer(tmp_path_factory.mktemp("ref"), timer=FakeClock())
    return tr.train(12), tr


def test_preemption_resume_matches_fault_free_run_bitwise(tmp_path,
                                                          fault_free):
    steps = 12
    ref_rep, ref = fault_free
    ref_sp = ref.seqpoints(error_threshold=0.1, n_threshold=32)
    # transient loader fault, one NaN rollback, preemption at 9 with the
    # emergency checkpoint silently corrupted, forcing restore to fall back
    # one step
    faults.install(FaultPlan.parse(
        "data_fetch@2,nan_loss@5,preempt@9,ckpt_corrupt@9"))
    ck = tmp_path / "ck"
    tr = _make_trainer(ck, timer=FakeClock())
    rep = tr.train(steps)
    assert rep.preempted and rep.steps == 9
    losses = list(rep.losses)
    pos = rep.steps
    resume_points = []
    for _ in range(4):                               # resume until complete
        if not rep.preempted and pos >= steps:
            break
        tr = _make_trainer(ck, timer=FakeClock())
        rep = tr.train(steps - pos)
        start = rep.resumed_from or 0
        resume_points.append(start)
        losses = losses[:start] + list(rep.losses)
        pos = start + rep.steps
    assert pos == steps
    assert resume_points[0] == 8                     # fell back past step 9
    assert losses == ref_rep.losses
    assert tr.epoch_log.to_jsonable() == ref.epoch_log.to_jsonable()
    sp = tr.seqpoints(error_threshold=0.1, n_threshold=32)
    assert sp.seq_lens == ref_sp.seq_lens
    np.testing.assert_array_equal(sp.weights, ref_sp.weights)
    assert (sp.k, sp.predicted, sp.actual) == \
        (ref_sp.k, ref_sp.predicted, ref_sp.actual)


def test_straggler_injection_is_flagged(tmp_path):
    faults.install(FaultPlan.parse("straggler@5:delay=1000"))
    tr = _make_trainer(tmp_path / "ck", timer=FakeClock())
    rep = tr.train(8)
    assert rep.stragglers == 1
    assert rep.step_times[5] == pytest.approx(1001.0)


def test_divergence_guard_rolls_back_in_trainer(tmp_path):
    tr = _make_trainer(tmp_path / "ck")
    tr.divergence = DivergenceDetector(ratio=1.5, patience=2, warmup=2)
    real_update = tr.divergence.update
    spiked = {"done": False}

    def scripted_update(loss, step=None):
        if step == 6 and not spiked["done"]:
            spiked["done"] = True
            real_update(loss * 100.0, step=step)
            real_update(loss * 100.0, step=step)
            return
        real_update(loss, step=step)

    tr.divergence.update = scripted_update
    rep = tr.train(10)
    assert rep.rollbacks >= 1
    assert rep.steps == 10


JAX_TINY = jc.smoke_config("starcoder2-3b").with_overrides(**TINY)


def _jax_reshard_count(jcfg, mesh_shape, mesh_axes, **opts):
    """The reference's ``reshard_state`` count for its config ``jcfg`` on
    the mesh, from its parameter shapes (``jax.eval_shape``: too few
    devices to build the mesh, so it counts and places nothing)."""
    model = jax_build_model(jcfg, JaxRuntime())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    run = SimpleNamespace(model=jcfg, mesh=JaxMeshConfig(
        shape=mesh_shape, axes=mesh_axes), fsdp=False, fsdp_over_pods=False,
        moe_full_ep=False, parallelism="tp")
    for k, v in opts.items():
        setattr(run, k, v)
    return jelastic.reshard_state(SimpleNamespace(params=shapes), run)[1]


def test_elastic_remesh_preserves_seqpoint_selection(tmp_path):
    steps = 12
    ref = _make_trainer(tmp_path / "ref", timer=FakeClock(), mesh_shape=(4,))
    ref_rep = ref.train(steps)
    ref_sp = ref.seqpoints(error_threshold=0.1, n_threshold=32)
    # host 2 dies at step 6; confirmed one pulse later; the trainer
    # checkpoints, shrinks the mesh to 3 hosts, and finishes in-process
    faults.install(FaultPlan.parse("peer_loss@6:host=2"))
    tr = _make_trainer(tmp_path / "ck", timer=FakeClock(), mesh_shape=(4,))
    sink = obs.EventSink(str(tmp_path / "events.jsonl"), flush_every=1)
    prev = obs.set_sink(sink)
    try:
        rep = tr.train(steps)
    finally:
        obs.set_sink(prev)
        sink.close()
    with open(tmp_path / "events.jsonl") as f:
        remesh = [e for e in map(json.loads, f) if e["kind"] == "remesh"]
    # the event carries the reference's count of sharded leaves on the
    # shrunken (3,) data mesh
    assert len(remesh) == 1
    assert remesh[0]["resharded_params"] == _jax_reshard_count(
        JAX_TINY, (3,), ("data",))
    assert rep.remeshes == 1 and rep.lost_hosts == [2]
    assert not rep.preempted and rep.steps == steps
    assert tr.run.mesh.shape == (3,)                 # DP axis shrunk
    assert tr.cluster.hosts == (0, 1, 2)             # survivors renumbered
    assert rep.losses == ref_rep.losses
    assert [it.seq_len for it in tr.epoch_log.iterations] == \
        [it.seq_len for it in ref.epoch_log.iterations]
    assert [it.runtime for it in tr.epoch_log.iterations] == \
        [it.runtime for it in ref.epoch_log.iterations]
    # the DP wire bytes follow the degree: 4 hosts, then 3
    wire = [it.stats["dp_wire_bytes"] for it in tr.epoch_log.iterations]
    assert wire[0] == ref.epoch_log.iterations[0].stats["dp_wire_bytes"]
    assert wire[-1] == pytest.approx(wire[0] * (2 / 3) / (3 / 4))
    sp = tr.seqpoints(error_threshold=0.1, n_threshold=32)
    assert sp.seq_lens == ref_sp.seq_lens
    np.testing.assert_array_equal(sp.weights, ref_sp.weights)


def test_elastic_remesh_without_ckpt_raises():
    faults.install(FaultPlan.parse("peer_loss@2:host=1"))
    tr = _make_trainer(mesh_shape=(4,))              # no ckpt: no tier 4
    with pytest.raises(PeerLossFault):
        tr.train(6)


def test_single_host_loss_is_cluster_failure(tmp_path):
    faults.install(FaultPlan.parse("peer_loss@2:host=0"))
    tr = _make_trainer(tmp_path / "ck")
    with pytest.raises(ClusterFailure):
        tr.train(6)


def test_skiplist_survives_preemption_resume(tmp_path):
    faults.install(FaultPlan.parse("nan_loss@5:times=2,preempt@8"))
    ck = tmp_path / "ck"
    tr = _make_trainer(ck)
    rep = tr.train(12)
    assert rep.rollbacks == 2 and rep.skipped_batches == 1
    assert rep.preempted and rep.steps == 8
    poisoned = tr.skiplist.poisoned
    assert poisoned
    tr2 = _make_trainer(ck)
    rep2 = tr2.train(12 - rep.steps)
    assert tr2.skiplist.poisoned == poisoned         # restored from extra
    assert rep2.rollbacks == 0                       # no rediscovery
    assert rep2.steps == 12 - rep.steps and not rep2.preempted


def test_reshard_state_keeps_placement():
    """The state comes back as it is, with the reference's count of
    sharded leaves: none on a (3,) data mesh; on a (2, 2) ("data",
    "model") mesh the tiny model's column- and row-parallel kernels."""
    cfg, run = _tiny_run(mesh_shape=(3,))
    model = build_model(cfg, Runtime.from_run(run), device="meta")
    state = SimpleNamespace(params=dict(model.named_parameters()))
    out, n = reshard_state(state, run)
    assert out is state and n == _jax_reshard_count(JAX_TINY, (3,), ("data",))
    _, run = _tiny_run(mesh_shape=(2, 2), mesh_axes=("data", "model"))
    _, n = reshard_state(state, run)
    assert n == _jax_reshard_count(JAX_TINY, (2, 2), ("data", "model")) > 0


@pytest.mark.parametrize("opts", [dict(), dict(fsdp=True),
                                  dict(moe_full_ep=True)],
                         ids=["tp", "fsdp", "moe_full_ep"])
def test_reshard_state_counts_the_reference_leaves_of_a_moe_arch(opts):
    """qwen2-moe-a2.7b at full width on a 2 x 4 ("data", "model") mesh,
    the port's model on the ``meta`` device: the count of sharded leaves
    equals the reference's (a stacked leaf counts once, as the reference's
    ``layers/0/ffn/e_wg`` is one leaf for all 24 layers)."""
    cfg = get_model_config("qwen2-moe-a2.7b")
    model = build_model(cfg, Runtime(), device="meta")
    _, run = _tiny_run(mesh_shape=(2, 4), mesh_axes=("data", "model"))
    run = dataclasses.replace(run, model=cfg, **opts)
    _, n = reshard_state(SimpleNamespace(params=dict(
        model.named_parameters())), run)
    assert n == _jax_reshard_count(jc.get_model_config("qwen2-moe-a2.7b"),
                                   (2, 4), ("data", "model"), **opts)
    assert 0 < n < sum(1 for _ in model.parameters())


# -------------------------------------------------------------------------
# the new resilience pieces against the reference's, on the same inputs


def test_fire_corrupt_delay_helpers():
    """The reference's own test (``tests/test_resilience.py``) on the
    port's hooks, with ``current`` and ``active``."""
    assert faults.current() is None and not faults.active()
    plan = FaultPlan.parse(
        "preempt@1,data_fetch@2,nan_loss@3,straggler@4:delay=0.75")
    faults.install(plan)
    assert faults.current() is plan and faults.active()
    faults.fire("preempt", 0)                        # no-op off-schedule
    with pytest.raises(PreemptionFault):
        faults.fire("preempt", 1)
    with pytest.raises(TransientFault):
        faults.fire("data_fetch", 2)
    assert faults.corrupt("nan_loss", 2, 1.5) == 1.5
    assert np.isnan(faults.corrupt("nan_loss", 3, 1.5))
    assert faults.delay("straggler", 4) == 0.75
    assert faults.delay("straggler", 5) == 0.0


def test_check_finite_matches_the_reference():
    for v in (1.25, 0.0, -3.0):
        assert check_finite(v) == jguards.check_finite(v) == v
    for v in (float("nan"), float("inf"), -float("inf")):
        with pytest.raises(NonFiniteLossError, match="step 7: grad_norm"):
            check_finite(v, name="grad_norm", step=7)
        with pytest.raises(jguards.NonFiniteLossError):
            jguards.check_finite(v, step=7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_divergence_detector_matches_the_reference(seed):
    """A loss stream with spikes: both raise at the same update, with the
    same EMA and streak."""
    r = np.random.RandomState(seed)
    losses = np.exp(r.randn(80) * 0.3)
    losses[r.rand(80) < 0.15] *= 10.0
    mine = DivergenceDetector(ratio=3.0, patience=2, warmup=4)
    ref = jguards.DivergenceDetector(ratio=3.0, patience=2, warmup=4)
    for i, x in enumerate(losses):
        raised = []
        for det, err in ((mine, DivergenceError),
                         (ref, jguards.DivergenceError)):
            try:
                det.update(float(x), step=i)
                raised.append(None)
            except err as e:
                raised.append(str(e))
                det.reset()
        assert raised[0] == raised[1]
        assert (mine.ema, mine.streak, mine.steps_seen) == \
            (ref.ema, ref.streak, ref.steps_seen)
    with pytest.raises(ValueError):
        DivergenceDetector(ratio=1.0)


def test_batch_skip_list_and_extras_match_the_reference():
    ops = [(0, 7), (0, 7), (1, 3), (0, 2), (1, 3), (0, 7)]
    mine, ref = BatchSkipList(skip_after=2), jrecovery.BatchSkipList(2)
    for key in ops:
        assert mine.record_failure(key) == ref.record_failure(key)
        assert mine.should_skip(key) == ref.should_skip(key)
    assert mine.state() == ref.state()
    json.dumps(mine.state())
    other = BatchSkipList(skip_after=2)
    other.restore(ref.state())
    other.restore({"failures": [[[0, 7], 1]], "skip": []})
    assert other.poisoned == mine.poisoned == ref.poisoned
    log, jlog = EpochLog(meta={"model": "m"}), JaxEpochLog(meta={"model": "m"})
    for sl, rt in ((32, 1.0), (64, 2.5), (32, 1.25)):
        log.append(sl, rt, dp_wire_bytes=10.0)
        jlog.append(sl, rt, dp_wire_bytes=10.0)
    data_state = {"epoch": 1, "batch_index": 4, "seed": 1}
    extra = pack_train_extra(9, data_state, log, mine)
    assert extra == jrecovery.pack_train_extra(9, data_state, jlog, ref)
    step, ds, back, skip = unpack_train_extra(json.loads(json.dumps(extra)))
    assert (step, ds, skip) == (9, data_state, mine.state())
    assert back.to_jsonable() == log.to_jsonable()
    assert unpack_train_extra({"step": 3})[1:] == (None, None, None)


@pytest.mark.parametrize("shape,axes,hosts", [
    ((4, 2), ("data", "model"), None), ((4, 2), ("data", "model"), 2),
    ((2, 4, 2), ("pod", "data", "model"), 4), ((8,), ("data",), None),
    ((2,), ("model",), None),
])
def test_failure_domains_match_the_reference(shape, axes, hosts):
    mine = FailureDomains.from_mesh(MeshConfig(shape=shape, axes=axes), hosts)
    ref = jelastic.FailureDomains.from_mesh(JaxMeshConfig(shape=shape,
                                                          axes=axes), hosts)
    assert (mine.num_hosts, mine.rows_per_host, mine.devices_per_host,
            mine.hosts) == (ref.num_hosts, ref.rows_per_host,
                            ref.devices_per_host, ref.hosts)
    n = mine.mesh.num_devices
    assert [mine.host_of(d) for d in range(n)] == \
        [ref.host_of(d) for d in range(n)]
    for h in mine.hosts:
        assert mine.devices_of(h) == ref.devices_of(h)
        assert mine.surviving_devices([h]) == ref.surviving_devices([h])
        if mine.num_hosts > 1 and "data" in axes:
            a, b = mine.surviving_mesh([h])[0], ref.surviving_mesh([h])[0]
            assert (a.shape, a.axes) == (b.shape, b.axes)
    with pytest.raises(ClusterFailure):
        mine.surviving_mesh(list(mine.hosts))


def test_failure_domains_reject_uneven_hosts():
    with pytest.raises(ValueError):
        FailureDomains.from_mesh(MeshConfig(shape=(4, 2),
                                            axes=("data", "model")), 3)


def test_peer_health_tracker_matches_the_reference():
    r = np.random.RandomState(0)
    mine = PeerHealthTracker([0, 1, 2, 3], confirm_misses=2)
    ref = jelastic.PeerHealthTracker([0, 1, 2, 3], confirm_misses=2)
    for tick in range(30):
        beats = {h for h in range(4) if r.rand() < 0.7}
        a, b = mine.observe(beats, tick), ref.observe(beats, tick)
        assert (a.tick, a.suspect, a.confirmed_lost) == \
            (b.tick, b.suspect, b.confirmed_lost)
    mine.forget([1])
    assert mine.hosts == (0, 2, 3)


@pytest.mark.parametrize("plan", [
    "peer_loss@3:host=1", "peer_slow@3:host=1:delay=0.1",
    "mesh_partition@2:host=2", "peer_loss@1:host=0,peer_loss@4:host=3",
])
def test_cluster_monitor_matches_the_reference(plan):
    """The same plan on both packages' monitors over a (4,) mesh: the same
    healthy hosts every pulse, the same confirmed losses and the same
    re-meshed survivors."""
    faults.install(FaultPlan.parse(plan))
    jfaults.install(jfaults.FaultPlan.parse(plan))
    mine = ClusterMonitor.from_mesh(MeshConfig(shape=(4,), axes=("data",)))
    ref = jelastic.ClusterMonitor.from_mesh(JaxMeshConfig(shape=(4,),
                                                          axes=("data",)))
    for tick in range(8):
        lost = []
        for mon, err in ((mine, PeerLossFault), (ref, jelastic.PeerLossFault)):
            try:
                mon.pulse(tick)
                lost.append(None)
            except err as e:
                lost.append((e.hosts, e.tick))
        assert lost[0] == lost[1]
        assert mine.healthy_hosts == ref.healthy_hosts
        if lost[0] is not None:
            a, b = mine.after_loss(lost[0][0]), ref.after_loss(lost[1][0])
            assert (a.hosts, a.domains.mesh.shape) == \
                (b.hosts, b.domains.mesh.shape)
            break
