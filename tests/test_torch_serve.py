"""The port's serving path against the JAX package's: ``run_batch`` and the
continuous batcher ``serve()`` on the same converted weights and the same
requests, on the CPU, for a dense GQA model (starcoder2-3b), a recurrent
one (rwkv6-3b) and a hybrid mamba/attention/MoE one (jamba-v0.1-52b). Greedy tokens must be identical; under a FakeClock, so
must every counter and clock reading of ``ServeStats`` and the serve
``EpochLog``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro.resilience import faults as jax_faults
from repro.resilience.recovery import RecoveryPolicy as JaxRecoveryPolicy
from repro.serve import engine as jeng
from repro.serve import sched as jsched
from repro_torch.configs import smoke_config
from repro_torch.models.convert import transformer_params_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.resilience import faults
from repro_torch.resilience.recovery import RecoveryPolicy
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import sched

# each arch at a vocab of 256 (the requests' token range), two layers or,
# for jamba, one period of its pattern (8 layers: 7 mamba, 1 attention, 4
# MoE). rwkv6-3b keeps d_model 128, and jamba d_model 64 (d_inner 128), so
# that no engine's max_len equals a state leaf's width: the JAX scheduler's
# splice tells a K/V leaf from a state leaf by that shape. deepseek-v3's
# MLA layers cache a latent pair, which takes the K/V splice
ARCHS = {"starcoder2-3b": dict(num_layers=2, d_model=64, d_ff=128,
                               vocab_size=256),
         "deepseek-v3-671b": dict(num_layers=2, d_model=64, d_ff=128,
                                  vocab_size=256),
         "rwkv6-3b": dict(num_layers=2, d_model=128, d_ff=256,
                          vocab_size=256),
         "jamba-v0.1-52b": dict(num_layers=8, d_model=64, d_ff=128,
                                vocab_size=256)}


class FakeClock:
    """One tick per call: latencies/TTFTs are bit-identical across runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    arch, tiny = request.param, ARCHS[request.param]
    jcfg = jax_smoke_config(arch).with_overrides(**tiny)
    jmodel = jax_build_model(jcfg, JaxRuntime())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(smoke_config(arch).with_overrides(**tiny),
                         device="cpu", seed=1)
    tmodel.load_state_dict(transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, tmodel


def _engines(models, **kw):
    """The JAX engine and the port's, built alike; each gets its own
    FakeClock when ``clock=True``."""
    jmodel, jparams, tmodel = models
    clock = kw.pop("clock", False)
    kw.setdefault("batch_size", 4)
    kw.setdefault("max_len", 160)
    kw.setdefault("sl_granularity", 8)
    jkw = dict(kw, policy=JaxRecoveryPolicy(backoff_base_s=0.0))
    tkw = dict(kw, policy=RecoveryPolicy(backoff_base_s=0.0))
    if clock:
        jkw["timer"], tkw["timer"] = FakeClock(), FakeClock()
    return (jeng.ServeEngine(jmodel, jparams, **jkw),
            ServeEngine(tmodel, device="cpu", **tkw))


def _requests(seed=0, n=16, wide_every=4, wide_sl=128):
    """Skewed-SL stream (as the JAX scheduler tests'), made twice from one
    seed: once as JAX requests, once as the port's."""
    def make(cls):
        rng = np.random.RandomState(seed)
        reqs = []
        for i in range(n):
            sl = wide_sl if i % wide_every == 0 else int(rng.randint(5, 9))
            reqs.append(cls(prompt=rng.randint(1, 255, size=sl).astype(
                np.int32), max_new_tokens=int(rng.randint(2, 6))))
        return reqs
    return make(jeng.Request), make(Request)


def _same_log(jlog, tlog):
    assert tlog.num_iterations == jlog.num_iterations
    for a, b in zip(tlog.iterations, jlog.iterations):
        assert (a.seq_len, a.runtime) == (b.seq_len, b.runtime)
        assert dict(a.stats) == dict(b.stats)


# ------------------------------------------------------------ run_batch


def test_run_batch_tokens_and_log_match_jax(models):
    je, te = _engines(models, clock=True, sl_granularity=32)
    for seed in (0, 1):
        jr, tr = _requests(seed=seed, n=4, wide_every=2, wide_sl=45)
        je.run_batch(jr)
        te.run_batch(tr)
        assert [r.output for r in tr] == [r.output for r in jr]
        assert all(len(r.output) == r.max_new_tokens for r in tr)
    assert te.log.iterations[0].seq_len == 64          # 45 padded to 32s
    _same_log(je.log, te.log)
    sp = te.seqpoints(error_threshold=0.5)
    assert sp.seq_lens == je.seqpoints(error_threshold=0.5).seq_lens


def test_run_batch_does_not_mutate_requests_and_truncates(models):
    """A prompt longer than max_len keeps its last max_len tokens; decode
    then writes past the cache's end, which the reference clamps onto the
    last slot (dynamic_update_slice) and the port mirrors, token for
    token."""
    je, te = _engines(models, max_len=64, sl_granularity=16)
    outs = []
    for eng, cls in ((je, jeng.Request), (te, Request)):
        reqs = [cls(prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=3),
                # prompt longer than max_len: must truncate, not crash
                cls(prompt=np.arange(1, 101, dtype=np.int32) % 256,
                    max_new_tokens=5)]
        out = eng.run_batch(reqs)
        # only the real requests come back; the caller's list is untouched
        assert out is reqs and len(reqs) == 2
        assert len(out[0].output) == 3 and len(out[1].output) == 5
        assert eng.log.num_iterations == 1
        assert eng.log.iterations[0].seq_len == 64
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]


def test_run_batch_decode_calls_and_stats_keys(models):
    """n useful tokens cost n - 1 decode calls (prefill supplies the first),
    and the serve EpochLog carries the reference's stats keys."""
    _, te = _engines(models, batch_size=2, max_len=64, sl_granularity=16)
    calls = {"n": 0}
    real_decode = te._decode

    def counting_decode(*a, **kw):
        calls["n"] += 1
        return real_decode(*a, **kw)

    te._decode = counting_decode
    reqs = [Request(prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=4)]
    te.run_batch(reqs)
    assert len(reqs[0].output) == 4 and calls["n"] == 3
    rec = te.log.iterations[-1]
    assert set(rec.stats) == {"decode_s", "decode_steps", "tokens_out",
                              "latency_s", "hedged", "curtailed", "replica"}
    assert rec.stats["decode_steps"] == 3.0 and rec.stats["decode_s"] >= 0
    calls["n"] = 0
    te.run_batch([Request(prompt=np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=1)])
    assert calls["n"] == 0


def test_run_batch_sheds_overload_and_deadline_curtails_like_jax(models):
    je, te = _engines(models, clock=True, deadline_s=3.0)
    jr, tr = _requests(seed=4, n=6)
    je.run_batch(jr)
    te.run_batch(tr)
    assert [r.shed for r in tr] == [r.shed for r in jr] == [False] * 4 \
        + [True] * 2
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.curtailed for r in tr] == [r.curtailed for r in jr]
    assert any(r.curtailed for r in tr)
    _same_log(je.log, te.log)


# -------------------------------------------------------------- serve()


def _policies():
    return {"fifo": (jsched.FifoPolicy(), sched.FifoPolicy()),
            "bucket_affine": (jsched.BucketAffinePolicy(),
                              sched.BucketAffinePolicy()),
            "seqpoint": (jsched.SeqPointPolicy(lambda sl: float(sl)),
                         sched.SeqPointPolicy(lambda sl: float(sl)))}


def _same_stats(ts, js):
    assert ts.summary() == js.summary()
    assert ts.admission_order == js.admission_order
    for key in ("prefill_cells", "prefill_useful", "decode_cells",
                "decode_useful"):
        assert getattr(ts, key) == getattr(js, key), key


@pytest.mark.parametrize("policy", sorted(_policies()))
def test_serve_matches_jax(models, policy):
    jpol, tpol = _policies()[policy]
    je, te = _engines(models, clock=True)
    jr, tr = _requests(seed=0)
    js = je.serve(jr, policy=jpol)
    ts = te.serve(tr, policy=tpol)
    _same_stats(ts, js)
    assert ts.n_finished == 16 and ts.n_curtailed == 0
    assert [r.output for r in tr] == [r.output for r in jr]
    _same_log(je.log, te.log)


def test_run_to_completion_matches_jax(models):
    je, te = _engines(models, clock=True)
    jr, tr = _requests(seed=0)
    _same_stats(sched.run_to_completion(te, tr),
                jsched.run_to_completion(je, jr))
    assert [r.output for r in tr] == [r.output for r in jr]


def test_serve_deadline_curtails_like_jax(models):
    je, te = _engines(models, clock=True, deadline_s=8.0)
    jr = [jeng.Request(prompt=np.arange(1, 17, dtype=np.int32),
                       max_new_tokens=500) for _ in range(2)]
    tr = [Request(prompt=np.arange(1, 17, dtype=np.int32),
                  max_new_tokens=500) for _ in range(2)]
    js = je.serve(jr, policy=jsched.FifoPolicy())
    ts = te.serve(tr, policy=sched.FifoPolicy())
    _same_stats(ts, js)
    assert ts.n_curtailed == 2
    assert all(r.curtailed and 0 < len(r.output) < 500 for r in tr)
    assert [r.output for r in tr] == [r.output for r in jr]
    _same_log(je.log, te.log)


def test_serve_sheds_on_bounded_queue_like_jax(models):
    je, te = _engines(models, clock=True)
    jr = [jeng.Request(prompt=np.arange(1, 9, dtype=np.int32),
                       max_new_tokens=2) for _ in range(6)]
    tr = [Request(prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
          for _ in range(6)]
    js = je.serve(jr, max_queue=4)
    ts = te.serve(tr, max_queue=4)
    _same_stats(ts, js)
    assert ts.n_shed == 2 and ts.n_finished == 4
    assert [r.shed for r in tr] == [False] * 4 + [True] * 2
    assert [r.output for r in tr] == [r.output for r in jr]
    assert all(r.output == [] for r in tr[4:])


def test_serve_with_faults_and_hedging_matches_jax(models):
    """Same fault plan (a decode retry, a slow replica) under FakeClock
    with two replicas: identical admissions, tokens, stats and log."""
    spec = "decode@3,peer_slow@2:delay=9.0"
    out = []
    for fmod in (jax_faults, faults):
        fmod.install(fmod.FaultPlan.parse(spec, seed=0))
    try:
        je, te = _engines(models, clock=True, n_replicas=2,
                          hedge_factor=3.0)
        jr, tr = _requests(seed=1, n=12)
        out = [je.serve(jr, policy=jsched.BucketAffinePolicy()),
               te.serve(tr, policy=sched.BucketAffinePolicy())]
    finally:
        for fmod in (jax_faults, faults):
            fmod.install(None)
    _same_stats(out[1], out[0])
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [r.curtailed for r in tr] == [r.curtailed for r in jr]
    _same_log(je.log, te.log)


def test_engine_without_device_raises_here(models):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(models[2])
    cuda_model = type("M", (), {"device": torch.device("cuda")})()
    with pytest.raises(ValueError, match="model is on"):
        ServeEngine(cuda_model, device="cpu")
