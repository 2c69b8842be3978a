"""The port's SeqPoint core, epoch planner and characterizer against the JAX
package's: the same EpochLog must give the same SeqPointSet, the same
samples the same plan, and a fake provider the same log and projections."""
import numpy as np
import pytest

import repro.core as jcore
from repro.core import characterize as jchar
from repro.data.batching import plan_epoch as jax_plan_epoch
from repro.data.synthetic import IWSLT_LIKE as JAX_IWSLT_LIKE
import repro_torch.core as tcore
from repro_torch.core import characterize as tchar
from repro_torch.data.batching import plan_epoch
from repro_torch.data.synthetic import IWSLT_LIKE


def _linear(sl):
    return 1e-3 * sl + 5e-3


# the distributions of tests/test_seqpoint.py: (seed, sls, runtime fn, noise)
DISTS = {
    "all_unique": (0, lambda r: [8, 16, 24, 32] * 25, _linear, 0.0),
    "uniform_500": (1, lambda r: r.randint(4, 400, size=500), _linear, 0.0),
    "power_1.5": (2, lambda r: r.randint(4, 400, size=800),
                  lambda s: 1e-5 * s ** 1.5 + 1e-3, 0.0),
    "uniform_2000": (3, lambda r: r.randint(4, 1000, size=2000), _linear,
                     0.0),
    "quadratic": (5, lambda r: r.randint(64, 4096, size=1500),
                  lambda s: 1e-9 * s ** 2 + 1e-4, 0.0),
    "noisy": (6, lambda r: r.randint(4, 200, size=400), _linear, 0.05),
    "skewed": (0, lambda r: [10] * 900 + [1000] * 100, _linear, 0.0),
    "extremes": (0, lambda r: [8, 9, 10] * 20 + [990, 1000] * 30, _linear,
                 0.0),
}

METHODS = {
    "seqpoint": lambda c, log: c.select_seqpoints(log, error_threshold=0.02),
    "frequent": lambda c, log: c.ALL_BASELINES["frequent"](log),
    "median": lambda c, log: c.ALL_BASELINES["median"](log),
    "worst": lambda c, log: c.ALL_BASELINES["worst"](log),
    "prior": lambda c, log: c.ALL_BASELINES["prior"](log),
    "kmeans": lambda c, log: c.kmeans_seqpoints(log, k=6),
}


def _logs(dist):
    seed, sls_fn, rt_fn, noise = DISTS[dist]
    rng = np.random.RandomState(seed)
    sls = sls_fn(rng)
    logs = (jcore.EpochLog(), tcore.EpochLog())
    for sl in sls:
        rt = max(rt_fn(sl) * (1 + noise * rng.randn()), 1e-9)
        for log in logs:
            log.append(int(sl), rt)
    return logs


def _as_tuple(s):
    return ([(p.seq_len, p.weight, p.runtime) for p in s.points], s.k,
            s.predicted, s.actual, s.error, s.method, s.meta)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("dist", sorted(DISTS))
def test_same_log_gives_same_seqpoint_set(dist, method):
    jlog, tlog = _logs(dist)
    assert jlog.to_jsonable() == tlog.to_jsonable()
    want = METHODS[method](jcore, jlog)
    got = METHODS[method](tcore, tlog)
    assert _as_tuple(got) == _as_tuple(want)


@pytest.mark.parametrize("samples,seed", [(6400, 0), (1280, 0), (3200, 7)])
def test_plan_epoch_matches_for_the_gnmt_setup(samples, seed):
    """batch 64, granularity 4, unsorted: the GNMT setup's plan."""
    plans = []
    for dist, plan_fn in ((JAX_IWSLT_LIKE, jax_plan_epoch),
                          (IWSLT_LIKE, plan_epoch)):
        sls = dist.sample(np.random.RandomState(seed), samples)
        plans.append(plan_fn(sls, 64, granularity=4, sort_first=False,
                             seed=seed))
    jplan, tplan = plans
    assert tplan.num_batches == jplan.num_batches
    np.testing.assert_array_equal(tplan.padded_sls, jplan.padded_sls)
    uniq = sorted(set(int(s) for s in jplan.padded_sls))
    assert sorted(set(int(s) for s in tplan.padded_sls)) == uniq
    assert ({s: int((tplan.padded_sls == s).sum()) for s in uniq}
            == {s: int((jplan.padded_sls == s).sum()) for s in uniq})
    assert tplan.padding_waste() == jplan.padding_waste()


class _FakeProvider:
    """Deterministic per-SL results with a profile cost, like a provider."""

    def __init__(self, result_cls):
        self.result_cls = result_cls
        self.cache = {}

    def profile(self, sl, machine=None):
        scale = 1.0 if machine is None else machine
        if sl not in self.cache:
            self.cache[sl] = self.result_cls(
                runtime=scale * _linear(sl), stats={"flops": 2.0 * sl},
                profile_cost=0.1 * sl)
        return self.cache[sl]


@pytest.mark.parametrize("machine", [None, 2.5])
def test_characterize_with_a_fake_provider_matches(machine):
    sls = IWSLT_LIKE.sample(np.random.RandomState(0), 1280)
    plan = plan_epoch(sls, 64, granularity=4)
    out = []
    for char, core in ((jchar, jcore), (tchar, tcore)):
        prov = _FakeProvider(char.ProfileResult)
        log = char.epoch_log_from_plan(plan, prov, machine=machine)
        points = core.select_seqpoints(log, error_threshold=0.02)
        out.append((log.to_jsonable(),
                    char.project_on_config(points, prov, machine=machine),
                    char.project_on_config(points, prov, machine=machine,
                                           kind="mean"),
                    char.profiling_cost(prov, points.seq_lens)))
    assert out[0] == out[1]
