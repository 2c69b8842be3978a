"""The port's wallclock reproduction, its profiler and its device rules,
on the CPU."""
import json
import time

import numpy as np
import pytest
import torch

from repro.data.batching import plan_epoch as jax_plan_epoch
from repro.data.synthetic import IWSLT_LIKE as JAX_IWSLT_LIKE
from repro_torch import resolve_device
from repro_torch.core import reproduction
from repro_torch.core.characterize import WallclockProvider
from repro_torch.core.reproduction import run_reproduction
from repro_torch.models.rnn import GNMT, GNMTConfig


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def results_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(reproduction, "RESULTS_DIR", str(tmp_path))
    return tmp_path


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
    assert set(w["methods"]) == {"seqpoint", "frequent", "median", "worst",
                                 "prior", "kmeans"}
    assert sorted(w["runtime_by_sl"]) == uniq
    assert all(np.isfinite(t) and t > 0 for t in w["runtime_by_sl"].values())
    sp = w["methods"]["seqpoint"]
    assert sp["error_pct"] <= 2.0 and sp["seq_lens"] == uniq
    assert w["profiling"]["full_seconds"] >= w["profiling"][
        "seqpoint_seconds"] > 0
    assert "analytic" not in res and "op_histograms" not in res
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
