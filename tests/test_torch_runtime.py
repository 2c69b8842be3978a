"""The port's ``Runtime`` knobs against the JAX package's, on the CPU at
smoke size: ``Runtime.from_run`` field by field; the loss and every
gradient under ``remat`` "none", "block" and "save_boundaries" (each
against the JAX model with the same mode) for starcoder2-3b, jamba (mamba,
attention and MoE in one period) and whisper (encoder and decoder layers);
models built at ``tp_degree=4``, whose padded heads give other parameter
shapes (rwkv6-3b's 2 smoke heads become 4, an attention arch with 6 query
heads gets 8); and a fixed ``attn_chunk`` against the reference's chunked
path. Same converted weights, same numpy-seeded batches. Tolerances: loss
rtol 1e-5; each gradient within 1e-4 of its largest |value| (float32 sums
taken in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro_torch import configs as tc
from repro_torch.models.convert import (
    encdec_params_from_jax,
    transformer_params_from_jax,
)
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime

B, S = 2, 32


def _convert(cfg):
    return encdec_params_from_jax if cfg.encoder is not None \
        else transformer_params_from_jax


def _batch(cfg, seed=0):
    r = np.random.RandomState(seed)
    out = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        out["frames"] = r.randn(B, cfg.encoder.max_source_len,
                                cfg.d_model).astype(np.float32)
    return out


def _pair(arch, jrt, trt, **overrides):
    """Loss and gradients of the JAX model and of the port loaded with its
    converted weights; returns (jax loss, port loss, jax grads, port grads)
    with the gradients as port state-dict names."""
    jcfg = jc.smoke_config(arch).with_overrides(**overrides)
    tcfg = tc.smoke_config(arch).with_overrides(**overrides)
    jmodel = jax_build_model(jcfg, jrt)
    params = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    (jloss, _), jgrad = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v)
                                  for k, v in batch.items()}),
        has_aux=True)(params)
    conv = _convert(jcfg)
    tmodel = build_model(tcfg, trt, device="cpu", seed=1)
    tmodel.load_state_dict(conv(jax.tree.map(np.asarray, params)),
                           strict=True)
    tb = {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                             else torch.float32) for k, v in batch.items()}
    tloss, _ = tmodel.loss(tb)
    tloss.backward()
    tgrad = {n: p.grad for n, p in tmodel.named_parameters()}
    jgrad = conv(jax.tree.map(np.asarray, jgrad))
    return float(jloss), float(tloss.detach()), jgrad, tgrad


def _check(jloss, tloss, jgrad, tgrad):
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert set(jgrad) == set(tgrad)
    for name, want in jgrad.items():
        want = want.numpy()
        got = tgrad[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name


def test_from_run_matches_the_reference_field_by_field():
    base = tc.RunConfig(model=tc.smoke_config("starcoder2-3b"),
                        shape=tc.ShapeConfig("t", S, B, tc.StepKind.TRAIN))
    jbase = jc.RunConfig(model=jc.smoke_config("starcoder2-3b"),
                         shape=jc.ShapeConfig("t", S, B, jc.StepKind.TRAIN))
    tp = dict(mesh=(2, 4))
    cases = [dict(), dict(remat="block"), dict(remat="save_boundaries"),
             dict(attn_chunk=512), dict(moe_full_ep=True),
             dict(param_dtype="float32", compute_dtype="float32"), tp,
             dict(tp, parallelism="dp_only"), dict(unroll_layers=2)]
    for case in cases:
        kw = dict(case)
        mesh = kw.pop("mesh", None)
        mine = Runtime.from_run(dataclasses.replace(
            base, **kw, **({"mesh": tc.MeshConfig(shape=mesh,
                                                  axes=("data", "model"))}
                           if mesh else {})))
        ref = JaxRuntime.from_run(dataclasses.replace(
            jbase, **kw, **({"mesh": jc.MeshConfig(shape=mesh,
                                                   axes=("data", "model"))}
                            if mesh else {})))
        for f in dataclasses.fields(mine):
            got, want = getattr(mine, f.name), getattr(ref, f.name)
            if f.name.endswith("dtype"):
                got, want = str(got).split(".")[-1], jnp.dtype(want).name
            assert got == want, (case, f.name)
    # the scan knobs have no counterpart in an eager loop
    assert {f.name for f in dataclasses.fields(JaxRuntime)} - \
        {f.name for f in dataclasses.fields(Runtime)} == \
        {"unroll_layers", "attn_unroll"}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-v0.1-52b",
                                  "whisper-medium"])
@pytest.mark.parametrize("remat", ["none", "block", "save_boundaries"])
def test_remat_loss_and_every_gradient_match_the_reference(arch, remat):
    _check(*_pair(arch, JaxRuntime(remat=remat), Runtime(remat=remat)))


@pytest.mark.parametrize("arch,overrides", [
    ("rwkv6-3b", {}),
    ("starcoder2-3b", {"num_heads": 6, "num_kv_heads": 2}),
    ("whisper-medium", {"num_heads": 6}),
])
def test_padded_heads_at_tp4_match_the_reference(arch, overrides):
    jloss, tloss, jgrad, tgrad = _pair(arch, JaxRuntime(tp_degree=4),
                                       Runtime(tp_degree=4), **overrides)
    # the padding is real: the model has more heads than the config
    shapes = {n: tuple(g.shape) for n, g in tgrad.items()}
    if arch == "rwkv6-3b":
        assert shapes["layers.0.mixer.ln_w"][0] == 4
    else:
        key = "layers.0.mixer.wq" if arch == "starcoder2-3b" \
            else "dec_layers.0.self.wq"
        assert shapes[key][1] == 8 * 32
    _check(jloss, tloss, jgrad, tgrad)


def test_padded_rwkv_cache_matches_the_reference():
    cfg = tc.smoke_config("rwkv6-3b")
    model = build_model(cfg, Runtime(tp_degree=4), device="cpu")
    jmodel = jax_build_model(jc.smoke_config("rwkv6-3b"),
                             JaxRuntime(tp_degree=4))
    want = jax.eval_shape(lambda: jmodel.init_cache(2, 16))
    got = model.init_cache(2, 16)
    assert tuple(got[0]["mixer"]["state"].shape) == \
        tuple(want[0]["mixer"]["state"].shape[1:])


@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-medium"])
def test_fixed_attn_chunk_matches_the_reference_chunked_path(arch):
    # S = 32 with an 8-key chunk takes the chunked path in both packages
    _check(*_pair(arch, JaxRuntime(attn_chunk=8), Runtime(attn_chunk=8)))
