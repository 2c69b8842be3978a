"""Training the archs with inputs beside the tokens against the JAX package
on the CPU (``tests/train_parity.py`` sets out the run and the bounds):
llava-next-34b with 8 patch embeddings in front of the tokens (their
labels -1) and whisper-medium (encoder over the frames, decoder with
cross-attention, the head tied to ``embed``), each under ``none`` and
``int8_ef``; and a JAX whisper ``TrainState`` resumed in the port."""
import numpy as np
import pytest
import torch

import repro_torch.configs as tc
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime
from repro_torch.train.train_step import (
    assign_state,
    build_train_step,
    init_train_state,
    train_state_from_jax,
)
from train_parity import (
    _assert_step_close,
    _check_metrics,
    batches,
    check_train_steps,
    jax_run,
    run_config,
    torch_batch,
)

WHISPER = "whisper-medium"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size ops are microseconds: threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["none", "int8_ef"])
@pytest.mark.parametrize("arch", ["llava-next-34b", WHISPER])
def test_train_steps_match_the_reference(arch, method):
    check_train_steps(arch, method)


def test_a_jax_whisper_state_resumes_in_the_port(tmp_path):
    """The reference's whisper state after two ``int8_ef`` steps (params,
    moments, residual), converted by ``train_state_from_jax``, saved by the
    port's ``CheckpointManager`` and restored into a fresh model's state
    (the init, overwritten), takes the third step as the reference does:
    its metrics within rtol 1e-5 and its state as the int8_ef steps of
    ``check_train_steps`` bound it."""
    states, jmetrics = jax_run(WHISPER, "int8_ef")
    cfg, run = run_config(tc, WHISPER, "int8_ef")
    model = build_model(cfg, Runtime.from_run(run), device="cpu")
    assert isinstance(model, EncDecLM)
    state = init_train_state(model, run)
    assign_state(state, train_state_from_jax(states[2]))
    assert state.opt.step == 2 and state.ef is not None
    CheckpointManager(str(tmp_path)).save(2, state, extra={"step": 2})
    fresh = build_model(cfg, Runtime.from_run(run), device="cpu")
    fresh.load_state_dict(train_state_from_jax(states[0]).params)
    resumed = init_train_state(fresh, run)
    restored, extra = CheckpointManager(str(tmp_path)).restore(resumed)
    assign_state(resumed, restored)
    assert extra == {"step": 2} and resumed.opt.step == 2
    for name, p in fresh.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      state.params[name].detach().numpy())
    step = build_train_step(fresh, run, total_steps=40)
    resumed, m = step(resumed, torch_batch(batches(cfg)[2]))
    _check_metrics(m, jmetrics[2], 2)
    _assert_step_close(resumed, states[3], 1e-3, 1e-3)
