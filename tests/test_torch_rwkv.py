"""The port's RWKV-6 blocks and a 2-layer rwkv6-3b against the JAX package's:
same converted weights, same numpy-seeded inputs, on the CPU. Time-mix and
channel-mix with and without a cache; the model's prefill logits and every
cache leaf at a length that takes the chunked WKV (128) and one that takes
the sequential WKV (96), decode steps and the loss. Tolerance rtol 1e-4 /
atol 1e-5: float32 sums are taken in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro.models import rwkv as jrw
from repro_torch.configs import smoke_config
from repro_torch.models import rwkv as trw
from repro_torch.models.convert import transformer_params_from_jax
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model_zoo import build_model

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "rwkv6-3b"


def _close(mine, want):
    np.testing.assert_allclose(mine.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _load(module, tree):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in tree.items()}, strict=True)
    return module


def _x(seed, b, s, d):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


@pytest.mark.parametrize("s", [128, 96, 1])
def test_time_mix_matches(s):
    """128 takes the chunked WKV, 96 the sequential one (both from a zero
    state, returning it), 1 a decode step from a random cache, which the
    port updates in place."""
    cfg = smoke_config(ARCH)
    jp = jrw.init_time_mix(jax.random.PRNGKey(s), jax_smoke_config(ARCH),
                           jnp.float32)
    tp = _load(trw.TimeMix(cfg, torch.Generator().manual_seed(0),
                           torch.float32), jp)
    x = _x(s, 2, s, cfg.d_model)
    jcache = cache = None
    if s == 1:
        r = np.random.RandomState(7)
        h, dh = cfg.d_model // 64, 64
        shift = r.randn(2, cfg.d_model).astype(np.float32)
        state = r.randn(2, h, dh, dh).astype(np.float32)
        jcache = {"shift": jnp.asarray(shift), "state": jnp.asarray(state)}
        cache = {"shift": torch.from_numpy(shift.copy()),
                 "state": torch.from_numpy(state.copy())}
    jy, jc = jrw.time_mix_forward(jp, jnp.asarray(x), jax_smoke_config(ARCH),
                                  cache=jcache, return_state=True)
    with torch.no_grad():
        y, c = trw.time_mix_forward(tp, torch.from_numpy(x), cfg,
                                    cache=cache, return_state=True)
    _close(y, jy)
    assert set(c) == {"shift", "state"}
    for name in c:
        _close(c[name], jc[name])
    if cache is not None:
        assert c is cache                  # written in place


@pytest.mark.parametrize("decode", [False, True])
def test_channel_mix_matches(decode):
    cfg = smoke_config(ARCH)
    jp = jrw.init_channel_mix(jax.random.PRNGKey(3), jax_smoke_config(ARCH),
                              jnp.float32)
    tp = _load(trw.ChannelMix(cfg, torch.Generator().manual_seed(0),
                              torch.float32), jp)
    x = _x(4, 2, 1 if decode else 33, cfg.d_model)
    jcache = cache = None
    if decode:
        shift = np.random.RandomState(5).randn(2, cfg.d_model).astype(
            np.float32)
        jcache = {"shift": jnp.asarray(shift)}
        cache = {"shift": torch.from_numpy(shift.copy())}
    jy, jc = jrw.channel_mix_forward(jp, jnp.asarray(x),
                                     jax_smoke_config(ARCH), cache=jcache,
                                     return_state=True)
    with torch.no_grad():
        y, c = trw.channel_mix_forward(tp, torch.from_numpy(x), cfg,
                                       cache=cache, return_state=True)
    _close(y, jy)
    _close(c["shift"], jc["shift"])


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config(ARCH), JaxRuntime())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(smoke_config(ARCH), device="cpu", seed=1)
    tmodel.load_state_dict(transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, tmodel.eval()


def _tokens(seed, b, s):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(
        np.int32)


def _same_caches(caches, jcaches):
    """Port: one dict per layer; JAX: the pattern entry's dict with each
    leaf stacked over layers."""
    jtree = jcaches[0]
    assert len(caches) == jtree["mixer"]["state"].shape[0]
    for i, c in enumerate(caches):
        assert {p: set(c[p]) for p in c} == {"mixer": {"shift", "state"},
                                            "ffn": {"shift"}}
        for part in c:
            for name, leaf in c[part].items():
                _close(leaf, jtree[part][name][i])


@pytest.mark.parametrize("s", [128, 96])
def test_prefill_logits_and_caches_match(models, s):
    jmodel, jparams, tmodel = models
    toks = _tokens(s, 3, s)
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, caches = tmodel.prefill(
            {"tokens": torch.as_tensor(toks, dtype=torch.long)})
    assert logits.shape == (3, 1, padded_vocab(512))
    _close(logits, jlogits)
    _same_caches(caches, jcaches)


def test_decode_steps_match(models):
    """Prefill 96 tokens, copy the prefill's leaves into a fresh cache with
    init_cache(prefix=), then 4 greedy decode steps: the logits of every
    step and the final caches agree."""
    jmodel, jparams, tmodel = models
    toks = _tokens(3, 2, 96)
    jlogits, jpre = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    jcache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice_in_dim(
            dst, src.astype(dst.dtype), 0, axis=2),
        jmodel.init_cache(2, 100), jpre)
    with torch.no_grad():
        logits, pre = tmodel.prefill(
            {"tokens": torch.as_tensor(toks, dtype=torch.long)})
        cache = tmodel.init_cache(2, 100, prefix=pre)
        assert cache[0]["mixer"]["state"] is not pre[0]["mixer"]["state"]
        _same_caches(cache, jcache)
        jtok = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        for step in range(4):
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            jl, jcache = jmodel.decode_step(jparams, jcache, jtok,
                                            jnp.asarray(96 + step, jnp.int32))
            lg, cache = tmodel.decode_step(cache, tok, 96 + step)
            _close(lg, jl)
            jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
            tok = lg.argmax(dim=-1)[:, None]
    _same_caches(cache, jcache)


def test_loss_matches(models):
    jmodel, jparams, tmodel = models
    toks = _tokens(5, 2, 64)
    labels = _tokens(6, 2, 64)
    labels[0, :3] = -1                     # ignored positions
    jloss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
    with torch.no_grad():
        loss, metrics = tmodel.loss(
            {"tokens": torch.as_tensor(toks, dtype=torch.long),
             "labels": torch.as_tensor(labels, dtype=torch.long)})
    _close(loss, jloss)
    assert set(metrics) == {"xent", "aux"}
