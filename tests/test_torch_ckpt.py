"""The port's checkpoint manager: every scenario of ``tests/test_ckpt.py``
(identity, atomicity, pruning, corruption, newest-first fallback, async
errors) on torch trees, plus what the port adds: bf16 leaves kept as raw
bits, the host snapshot ``save_async`` takes before it returns, trees of
dataclasses and a train state. Restores are compared for equality."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.resilience import faults
from repro_torch.resilience.faults import FaultPlan, TransientFault
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState


@pytest.fixture(autouse=True)
def _no_global_faults():
    prev = faults.install(None)
    yield
    faults.install(prev)


def make_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32)},
            "stack": (torch.ones(3, 4), torch.zeros(2))}


def zeros_like(tree):
    if isinstance(tree, dict):
        return {k: zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


def assert_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_save_restore_identity(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()
    mgr.save(10, state, extra={"step": 10, "note": "x"})
    restored, extra = mgr.restore(zeros_like(state))
    assert extra["step"] == 10 and extra["note"] == "x"
    assert_equal(state, restored)


def test_keep_last_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, make_state(s))
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, make_state())
    _corrupt(tmp_path, 5)
    with pytest.raises(IOError):
        mgr.restore(make_state())


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()
    mgr.save_async(7, state, extra={"step": 7})
    mgr.wait()
    restored, extra = mgr.restore(zeros_like(state))
    assert extra["step"] == 7
    assert_equal(state, restored)


def test_save_async_snapshots_before_it_returns(tmp_path):
    """The next optimizer step writes the parameters in place while the
    background thread writes: the checkpoint holds the values at the call."""
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()
    want = {"a": state["a"].clone(), "nested": {"b": state["nested"]["b"]
                                                .clone()},
            "stack": tuple(t.clone() for t in state["stack"])}
    mgr.save_async(1, state)
    state["a"].add_(1.0)
    state["stack"][0].mul_(3.0)
    mgr.wait()
    restored, _ = mgr.restore(zeros_like(state))
    assert_equal(want, restored)


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state())
    bad = {"a": torch.zeros(4, 4),
           "nested": {"b": torch.zeros(10, dtype=torch.int32)},
           "stack": (torch.ones(3, 4), torch.zeros(2))}
    with pytest.raises(ValueError):
        mgr.restore(bad)
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(dict(make_state(), extra=torch.zeros(1)))


def test_no_tmp_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, make_state())
    assert not any(n.endswith(".tmp") for n in os.listdir(str(tmp_path)))


def _corrupt(tmp_path, step):
    npz = os.path.join(str(tmp_path), f"step_{step:08d}", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02\x03")


def test_corrupt_latest_falls_back_one_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state(1), extra={"step": 1})
    mgr.save(2, make_state(2), extra={"step": 2})
    _corrupt(tmp_path, 2)
    before = obs.metrics.counter("ckpt_fallback_total").value
    restored, extra = mgr.restore(zeros_like(make_state()))
    assert extra["step"] == 1                   # fell back past the damage
    assert obs.metrics.counter("ckpt_fallback_total").value == before + 1
    assert_equal(make_state(1), restored)


def test_truncated_latest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state(1), extra={"step": 1})
    mgr.save(2, make_state(2), extra={"step": 2})
    npz = os.path.join(str(tmp_path), "step_00000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(64)                          # killed writer / bad disk
    _, extra = mgr.restore(make_state())
    assert extra["step"] == 1


def test_explicit_step_is_strict_by_default(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state(1), extra={"step": 1})
    mgr.save(2, make_state(2), extra={"step": 2})
    _corrupt(tmp_path, 2)
    with pytest.raises(IOError):
        mgr.restore(make_state(), step=2)       # pinned: no silent fallback
    _, extra = mgr.restore(make_state(), step=2, fallback=True)
    assert extra["step"] == 1


def test_verify_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state(1))
    assert mgr.verify_step(1)
    _corrupt(tmp_path, 1)
    assert not mgr.verify_step(1)
    assert not mgr.verify_step(99)              # missing step is not valid


def test_async_write_failure_surfaces_at_next_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()

    def boom(step, flat, dtypes, extra):
        raise IOError("disk on fire")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save_async(1, state)                    # background failure...
    monkeypatch.undo()
    with pytest.raises(IOError, match="disk on fire"):
        mgr.save(2, state)                      # ...surfaces here
    mgr.save(2, state)                          # error is consumed; works
    assert mgr.latest_step() == 2


def test_async_write_failure_surfaces_at_wait_and_save_async(tmp_path):
    faults.install(FaultPlan.parse("ckpt_save@1,ckpt_save@2"))
    mgr = CheckpointManager(str(tmp_path))
    before = obs.metrics.counter("ckpt_async_errors_total").value
    mgr.save_async(1, make_state())
    with pytest.raises(TransientFault):
        mgr.wait()
    mgr.wait()                                  # consumed
    mgr.save_async(2, make_state())
    with pytest.raises(TransientFault):
        mgr.save_async(3, make_state())         # the step-2 failure
    assert obs.metrics.counter("ckpt_async_errors_total").value == before + 2
    assert mgr.steps() == []                    # step 3 never started


def test_injected_corruption_is_caught_at_restore(tmp_path):
    faults.install(FaultPlan.parse("ckpt_corrupt@2"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state(1), extra={"step": 1})
    mgr.save(2, make_state(2), extra={"step": 2})
    assert mgr.verify_step(1) and not mgr.verify_step(2)
    _, extra = mgr.restore(make_state())
    assert extra["step"] == 1


def test_bf16_leaves_round_trip_as_raw_bits(tmp_path):
    """numpy has no bfloat16: the bits go to disk as uint16 and the
    manifest says bfloat16; every bit comes back, NaN and -0 included."""
    mgr = CheckpointManager(str(tmp_path))
    x = torch.randn(5, 7).to(torch.bfloat16)
    x[0, 0], x[0, 1], x[0, 2] = float("nan"), -0.0, float("inf")
    mgr.save(1, {"w": x, "f": torch.ones(3)})
    with open(os.path.join(str(tmp_path), "step_00000001",
                           "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert arrays["w"]["dtype"] == "bfloat16"
    assert arrays["f"]["dtype"] == "float32"
    with np.load(os.path.join(str(tmp_path), "step_00000001",
                              "arrays.npz")) as z:
        assert z["w"].dtype == np.uint16
    restored, _ = mgr.restore({"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                               "f": torch.zeros(3)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), x.view(torch.int16))


def test_train_state_round_trip(tmp_path):
    """A TrainState of dataclasses with an int step and no residual: the
    None leaf vanishes, the step comes back an int, paths name fields."""
    params = {"embed": torch.randn(4, 3), "layers.0.ffn.wi": torch.randn(3, 2)}
    state = TrainState(params=params, opt=OptState(
        step=7, m={k: torch.randn(v.shape) for k, v in params.items()},
        v={k: torch.rand(v.shape) for k, v in params.items()}), ef=None)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, extra={"step": 7})
    with open(os.path.join(str(tmp_path), "step_00000007",
                           "manifest.json")) as f:
        assert sorted(json.load(f)["arrays"]) == [
            "opt/m/embed", "opt/m/layers.0.ffn.wi", "opt/step",
            "opt/v/embed", "opt/v/layers.0.ffn.wi", "params/embed",
            "params/layers.0.ffn.wi"]
    like = TrainState(params={k: torch.zeros_like(v) for k, v in
                              params.items()},
                      opt=OptState(step=0, m={k: torch.zeros_like(v) for k, v
                                              in params.items()},
                                   v={k: torch.zeros_like(v) for k, v in
                                      params.items()}))
    restored, _ = mgr.restore(like)
    assert isinstance(restored, TrainState) and restored.ef is None
    assert restored.opt.step == 7 and isinstance(restored.opt.step, int)
    for a, b in ((restored.params, params), (restored.opt.m, state.opt.m),
                 (restored.opt.v, state.opt.v)):
        assert_equal(a, b)
