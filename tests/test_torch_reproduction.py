"""The port's reproduction (both tracks, both networks), its profiler and
its device rules, on the CPU."""
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.reproduction as jrepro
from repro.core.characterize import CompiledCostProvider as JaxCompiled
from repro.core.characterize import ProfileResult as JaxProfileResult
from repro.data.batching import plan_epoch as jax_plan_epoch
from repro.data.synthetic import IWSLT_LIKE as JAX_IWSLT_LIKE
from repro.data.synthetic import LIBRISPEECH_LIKE as JAX_LIBRISPEECH_LIKE
from repro.perfmodel.machine import MachineConfig as JaxMachineConfig
from repro_torch import resolve_device
from repro_torch.core import reproduction
from repro_torch.core.characterize import WallclockProvider
from repro_torch.core.reproduction import run_reproduction
from repro_torch.models.rnn import GNMT, GNMTConfig, same_out
from repro_torch.perfmodel.machine import PAPER_CONFIGS

METHODS = {"seqpoint", "frequent", "median", "worst", "prior", "kmeans"}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def results_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(reproduction, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def _check_analytic(a: dict, uniq: list) -> None:
    """Track A in the reference's key layout, counted on every SL."""
    assert set(a) == {"actual_seconds", "methods", "per_sl_speedup",
                      "per_sl_stats"}
    assert set(a["actual_seconds"]) == set(PAPER_CONFIGS)
    assert set(a["methods"]) == METHODS
    for m in a["methods"].values():
        assert set(m) == {"per_config", "geomean_time_error_pct",
                          "num_points"}
        assert set(m["per_config"]) == set(PAPER_CONFIGS)
        for c in m["per_config"].values():
            assert set(c) == {"time_error_pct", "speedup_actual",
                              "speedup_pred", "speedup_error_pp"}
            assert all(math.isfinite(v) for v in c.values())
    assert a["methods"]["seqpoint"]["per_config"]["config1"][
        "time_error_pct"] <= 2.0
    assert set(a["per_sl_speedup"]) == set(PAPER_CONFIGS) - {"config1"}
    assert all(sorted(v) == uniq for v in a["per_sl_speedup"].values())
    assert sorted(a["per_sl_stats"]) == uniq
    stats = [a["per_sl_stats"][sl] for sl in uniq]
    assert all(st["coll_bytes"] == 0.0 for st in stats)
    # every timestep is counted: FLOPs and bytes grow with the SL
    for key in ("flops", "bytes"):
        assert all(0 < x[key] < y[key] for x, y in zip(stats, stats[1:]))


def test_run_reproduction_end_to_end_on_cpu(results_dir):
    res = run_reproduction("gnmt", device="cpu", samples=128, force=True)
    # the plan is the JAX package's for the same samples
    sls = JAX_IWSLT_LIKE.sample(np.random.RandomState(0), 128)
    plan = jax_plan_epoch(sls, 64, granularity=4, sort_first=False, seed=0)
    uniq = sorted(set(int(s) for s in plan.padded_sls))
    assert res["device"] == "cpu"
    assert res["num_iterations"] == plan.num_batches == 2
    assert res["unique_sls"] == uniq
    assert res["sl_histogram"] == {s: int((plan.padded_sls == s).sum())
                                   for s in uniq}
    assert res["padding_waste"] == plan.padding_waste()
    w = res["wallclock"]
    assert set(w["methods"]) == METHODS
    assert sorted(w["runtime_by_sl"]) == uniq
    assert all(np.isfinite(t) and t > 0 for t in w["runtime_by_sl"].values())
    sp = w["methods"]["seqpoint"]
    assert sp["error_pct"] <= 2.0 and sp["seq_lens"] == uniq
    assert w["profiling"]["full_seconds"] >= w["profiling"][
        "seqpoint_seconds"] > 0
    _check_analytic(res["analytic"], uniq)
    # the reference draws op histograms only for 4 unique SLs or more
    assert "op_histograms" not in res
    # written in the JAX package's schema, and read back unless forced
    path = results_dir / "repro_torch_gnmt.json"
    assert json.loads(path.read_text())["unique_sls"] == uniq
    assert run_reproduction("gnmt", device="cpu") == json.loads(
        path.read_text())


def test_run_reproduction_without_device_needs_a_card(no_card, results_dir):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_reproduction("gnmt", samples=128, force=True)
    assert not list(results_dir.iterdir())


def test_default_device_is_cuda_and_cpu_must_be_asked_for(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        GNMT(GNMTConfig(vocab_size=16, d_model=4, num_enc_uni=1, num_dec=2))
    with pytest.raises(RuntimeError):
        WallclockProvider(lambda sl: (None, ()))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def test_wallclock_provider_counts_warmup_as_profile_cost():
    calls = []

    def step(x):
        calls.append(x)
        time.sleep(0.002)

    prov = WallclockProvider(lambda sl: (step, (sl,)), repeats=3,
                             device="cpu")
    res = prov.profile(12)
    assert calls == [12] * 4                   # warmup + 3 repeats
    # warmup + three repeats: at least twice their median
    assert res.runtime >= 0.002 and res.profile_cost >= 2 * res.runtime
    assert prov.profile(12) is res and len(calls) == 4   # cached


def test_step_leaves_the_parameters_unchanged():
    """The JAX step returns updated params that are dropped; the port's
    step must not carry an update into the next repeat either."""
    setup = reproduction.SETUPS["gnmt"](
        torch.device("cpu"),
        GNMTConfig(vocab_size=64, d_model=8, num_enc_uni=1, num_dec=2))
    step, args = setup["step_builder"](8)
    loss1, new1 = step(*args)
    loss2, new2 = step(*args)
    assert loss1.item() == loss2.item()
    assert all(torch.equal(a, b) for a, b in zip(new1, new2))


def test_run_reproduction_steps_run_without_tf32(results_dir, monkeypatch):
    """config1's peak is the fp32 rate, so the steps run with TF32 off
    (torch leaves it on for cuDNN's convolutions by default), and the
    caller's flags come back afterwards."""
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    seen = []
    gnmt_setup = reproduction.SETUPS["gnmt"]

    def setup(dev, cfg):
        s = gnmt_setup(dev, cfg)

        def builder(key):
            def build(sl):
                seen.append((key, flags()))
                return s[key](sl)
            return build
        return {**s, "step_builder": builder("step_builder"),
                "count_builder": builder("count_builder")}

    monkeypatch.setitem(reproduction.SETUPS, "gnmt", setup)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    run_reproduction("gnmt", device="cpu", samples=128, force=True,
                     model_config=GNMTConfig(vocab_size=64, d_model=8,
                                             num_enc_uni=1, num_dec=2))
    assert {k for k, _ in seen} == {"step_builder", "count_builder"}
    assert {f for _, f in seen} == {(False, False)}
    assert flags() == (True, True)


@pytest.fixture(scope="module")
def ds2_run(tmp_path_factory):
    """``run_reproduction("ds2")`` at the JAX package's small DS2 on 128
    samples, once for the tests below."""
    with pytest.MonkeyPatch.context() as mp:
        out = tmp_path_factory.mktemp("ds2")
        mp.setattr(reproduction, "RESULTS_DIR", str(out))
        res = run_reproduction("ds2", device="cpu", samples=128, force=True)
        return res, out


def test_run_reproduction_ds2_end_to_end_on_cpu(ds2_run):
    res, out = ds2_run
    sls = JAX_LIBRISPEECH_LIKE.sample(np.random.RandomState(0), 128)
    plan = jax_plan_epoch(sls, 32, granularity=64, sort_first=True, seed=0)
    uniq = sorted(set(int(s) for s in plan.padded_sls))
    assert res["network"] == "ds2" and res["device"] == "cpu"
    assert res["num_iterations"] == plan.num_batches == 4
    assert res["unique_sls"] == uniq == [704, 960, 1152, 1728]
    assert res["sl_histogram"] == {s: int((plan.padded_sls == s).sum())
                                   for s in uniq}
    w = res["wallclock"]
    assert set(w["methods"]) == METHODS
    assert all(np.isfinite(t) and t > 0 for t in w["runtime_by_sl"].values())
    assert w["methods"]["seqpoint"]["error_pct"] <= 2.0
    _check_analytic(res["analytic"], uniq)
    # the four picks of the reference: first, second, middle and last SL
    hist = res["op_histograms"]
    assert sorted(hist) == [704, 960, 1152, 1728]
    for sl, h in hist.items():
        frames = same_out(same_out(sl))        # two SAME stride-2 convs
        # one update-gate addmm per GRU step, 2 layers x 2 directions
        assert h["addmm:f32[8,128]"] == 4 * frames
        assert any(k.startswith("convolution:") for k in h)
    assert json.loads((out / "repro_torch_ds2.json").read_text())[
        "unique_sls"] == uniq


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    else:
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-300), (path, a, b)


def test_track_a_arithmetic_equals_the_reference(ds2_run, monkeypatch,
                                                 tmp_path):
    """The reference's own Track A code, fed the port's per-SL counts
    (preset in its CompiledCostProvider) and the port's machine numbers
    (as its MachineConfigs), gives the port's block to 1e-12."""
    res, _ = ds2_run
    counts = {sl: (st["flops"], st["bytes"], st["coll_bytes"])
              for sl, st in res["analytic"]["per_sl_stats"].items()}

    class Preset(JaxCompiled):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.cost_cache.update(counts)

    class FixedWallclock:
        def __init__(self, step_builder, repeats=3):
            self.cache = {}

        def profile(self, sl):
            return self.cache.setdefault(sl, JaxProfileResult(
                runtime=1e-3 * sl))

    def setup():
        # Track W is not compared; a trivial step keeps its lowering cheap
        return dict(step_builder=lambda sl: (lambda x: 2.0 * x,
                                             (jnp.zeros(8),)),
                    dist=JAX_LIBRISPEECH_LIKE, batch_size=32,
                    granularity=64, sort_first=True, samples=3200)

    monkeypatch.setattr(jrepro, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(jrepro, "CompiledCostProvider", Preset)
    monkeypatch.setattr(jrepro, "WallclockProvider", FixedWallclock)
    monkeypatch.setattr(jrepro, "PAPER_CONFIGS", {
        c: JaxMachineConfig(m.name, m.peak_flops, m.hbm_bw, m.ici_bw,
                            m.chips) for c, m in PAPER_CONFIGS.items()})
    monkeypatch.setitem(jrepro.SETUPS, "ds2", setup)
    want = jrepro.run_reproduction("ds2", samples=128, force=True)
    assert want["unique_sls"] == res["unique_sls"]
    _close(res["analytic"], want["analytic"])
