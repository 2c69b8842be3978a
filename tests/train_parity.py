"""The train step of one arch of the zoo against the JAX package's, on the
CPU in float32 at the arch's ``smoke_config``: shared by
``tests/test_torch_train_{recurrent,moe,frontends}.py``, one file a
family, so that ``--dist loadfile`` spreads them over workers.

Both packages start from the JAX init, converted, and take the same
numpy-seeded batches (4 x 32 tokens; llava's 8 patch embeddings, whisper's
frames at the smoke encoder's source length), AdamW at lr 1e-3 after a
2-step warmup, so the first of four steps runs at lr 0.

- ``none``: four steps, each package on its own state. ``loss``,
  ``xent``, ``grad_norm``, ``lr`` and, where the arch reports them,
  ``aux`` and ``mtp`` within rtol 1e-5; the state within
  ``_assert_state_close``'s bounds (lr x steps with lr > 0 is 2.5e-3).
- ``int8_ef``: each of the four steps starts from the reference's state
  before it, converted by ``train_state_from_jax`` (params, moments and
  the residual), and is held as above, its state against the reference's
  after it with ``flips=1e-3``. Run free, the packages part: a gradient
  entry whose ``g / scale`` lies within float noise of a rounding tie
  gets the other int8 code (rwkv6-3b: 10 codes at the first step, each
  within 1.3e-4 of a tie), error feedback carries the whole code step
  into the next step's residual and Adam turns it into an lr-sized move,
  so 1328 codes differ by the fourth step and its grad norm by 5.3e-4
  relative (jamba: the loss by 9.9e-4). One step from a shared state
  holds the port to the reference at every step without that cascade.

Tolerances: the parameters within 0.02 x lr x steps absolute, whatever
their scale (Adam's step is lr-sized whatever the gradient's); moments
and the residual relative to max |reference| of each leaf, which is what
holds the MoE leaves, whose values reach 10^3-10^4 (``dense_init``'s
``fan_in = E``), to the same bound as the others.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jc
import repro_torch.configs as tc
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro.train.train_step import build_train_step as jax_build_train_step
from repro.train.train_step import init_train_state as jax_init_train_state
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime
from repro_torch.train.train_step import (
    assign_state,
    build_train_step,
    init_train_state,
    train_state_from_jax,
)
from test_torch_train import _assert_state_close

STEPS = 4
BATCH, TOKENS, PATCHES = 4, 32, 8
METRIC_RTOL = 1e-5
# lr 1e-3 after a 2-step warmup: 0, 5e-4, 1e-3, 9.98e-4
LR_STEPS = 2.5e-3


def run_config(pkg, arch: str, method: str):
    """``arch``'s smoke config and a float32 run of it in either package."""
    cfg = pkg.smoke_config(arch)
    return cfg, pkg.RunConfig(
        model=cfg, shape=pkg.ShapeConfig("smoke", seq_len=TOKENS,
                                         global_batch=BATCH,
                                         step=pkg.StepKind.TRAIN),
        mesh=pkg.MeshConfig(shape=(1,), axes=("data",)),
        optimizer=pkg.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                      grad_compression=method),
        param_dtype="float32", compute_dtype="float32")


def batches(cfg, n: int = STEPS):
    """``n`` numpy batches: tokens and labels (the first row's first three
    labels -1), llava's patch embeddings, whisper's frames."""
    r = np.random.RandomState(0)
    out = []
    for _ in range(n):
        b = {"tokens": r.randint(0, cfg.vocab_size, (BATCH, TOKENS)),
             "labels": r.randint(0, cfg.vocab_size, (BATCH, TOKENS))}
        b = {k: v.astype(np.int32) for k, v in b.items()}
        b["labels"][0, :3] = -1
        if cfg.frontend == "image_patches":
            b["patches"] = r.randn(BATCH, PATCHES, cfg.d_model).astype(
                np.float32)
        if cfg.encoder is not None:
            b["frames"] = r.randn(BATCH, cfg.encoder.max_source_len,
                                  cfg.d_model).astype(np.float32)
        out.append(b)
    return out


def torch_batch(b):
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                               else torch.float32) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_run(arch: str, method: str):
    """The reference's four steps: the states before and after each (numpy
    leaves) and each step's metrics (kept for the module's other tests)."""
    cfg, run = run_config(jc, arch, method)
    model = jax_build_model(cfg, JaxRuntime.from_run(run))
    state = jax_init_train_state(model, run, jax.random.PRNGKey(0))
    step = jax.jit(jax_build_train_step(model, run, total_steps=40))
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for b in batches(cfg):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _check_metrics(m, want, step: int):
    assert set(m) == set(want), (sorted(m), sorted(want))
    for k, v in want.items():
        np.testing.assert_allclose(float(m[k]), v, rtol=METRIC_RTOL,
                                   err_msg=f"step {step}: {k}")


def _assert_step_close(mine, ref, lr: float, flips: float) -> None:
    """One ``int8_ef`` step from the reference's state: every tensor as
    ``_assert_state_close`` bounds it (parameters within 0.02 x lr,
    moments within 1e-4 and the residual within 1e-2 of max |reference|),
    except that a share ``flips`` of all the parameters' (the moments',
    the residual's) entries may miss it: an int8 code that rounds the
    other way at a float-noise tie moves its entry's gradient by a whole
    code step. Such a parameter entry stays within 2.01 x lr of the
    reference's: each package's Adam step is at most 1.002 x lr at betas
    (0.9, 0.95) over four steps (Cauchy-Schwarz on the moments' weights),
    and the two may point opposite ways."""
    ref = train_state_from_jax(ref)
    assert mine.opt.step == ref.opt.step
    parts = [(mine.params, ref.params, 0.02 * lr, 2.01 * lr),
             (mine.opt.m, ref.opt.m, 1e-4, None),
             (mine.opt.v, ref.opt.v, 1e-4, None),
             (mine.ef, ref.ef, 1e-2, None)]
    for a, b, tol, cap in parts:
        assert sorted(a) == sorted(b)
        off = total = 0
        for name in a:
            want = b[name].numpy()
            diff = np.abs(a[name].detach().float().numpy() - want)
            off += int((diff > (tol if cap is not None
                                else tol * np.abs(want).max())).sum())
            total += diff.size
            if cap is not None:
                assert diff.max() <= cap, (name, float(diff.max()), cap)
        assert off <= flips * total, (off, total)


def check_train_steps(arch: str, method: str) -> None:
    """The port's ``build_train_step`` against the reference's, as the
    module docstring sets out."""
    states, jmetrics = jax_run(arch, method)
    cfg, run = run_config(tc, arch, method)
    model = build_model(cfg, Runtime.from_run(run), device="cpu")
    init = train_state_from_jax(states[0])
    model.load_state_dict(init.params, strict=True)
    step = build_train_step(model, run, total_steps=40)
    state = init_train_state(model, run)
    assert (state.ef is None) == (method == "none")
    lrs = [0.0, 5e-4, 1e-3, 1e-3]
    for i, (b, want) in enumerate(zip(batches(cfg), jmetrics)):
        if method != "none":
            assign_state(state, train_state_from_jax(states[i]))
        state, m = step(state, torch_batch(b))
        _check_metrics(m, want, i)
        if method != "none":
            _assert_step_close(state, states[i + 1], lrs[i], 1e-3)
    if method == "none":
        _assert_state_close(state, states[-1], 0.02, LR_STEPS)
