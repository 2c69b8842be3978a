"""whisper-medium's encoder-decoder against the JAX package's ``EncDecLM`` on
the CPU, at smoke size (2 + 2 layers, d_model 128, 64 source frames): the
same converted weights and numpy-seeded frames and tokens give the same
encoder output, loss, gradients, prefill logits and caches (self and
cross), and decode steps through ``init_cache(prefix=)``. Tolerance rtol
1e-4 and atol 1e-5 relative to the largest |value|, as the decoder-only
zoo's tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro_torch.configs import smoke_config
from repro_torch.models.convert import encdec_params_from_jax
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import layer_norm, padded_vocab
from repro_torch.models.model_zoo import build_model

ARCH = "whisper-medium"


def _close(mine, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(mine.detach().float().numpy(), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_smoke_config(ARCH), JaxRuntime())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(smoke_config(ARCH), device="cpu", seed=1)
    assert isinstance(tmodel, EncDecLM)
    tmodel.load_state_dict(encdec_params_from_jax(
        jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, tmodel.eval()


def _batch(seed, b, s, labels=False):
    r = np.random.RandomState(seed)
    se = smoke_config(ARCH).encoder.max_source_len
    out = {"frames": r.randn(b, se, 128).astype(np.float32),
           "tokens": r.randint(0, 512, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = r.randint(0, 512, (b, s)).astype(np.int32)
        out["labels"][0, :3] = -1
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                               else torch.float32)
            for k, v in batch.items()}


def test_layer_norm_matches():
    r = np.random.RandomState(0)
    x, w, b = (r.randn(3, 7, 16).astype(np.float32) * 3 + 1,
               r.randn(16).astype(np.float32), r.randn(16).astype(np.float32))
    _close(layer_norm(*(torch.from_numpy(a) for a in (x, w, b))),
           jlayers.layer_norm(*(jnp.asarray(a) for a in (x, w, b))))


def test_encode_matches(models):
    jmodel, jparams, tmodel = models
    frames = _batch(0, 2, 4)["frames"]
    want = jmodel.encode(jparams, jnp.asarray(frames))
    with torch.no_grad():
        _close(tmodel.encode(torch.from_numpy(frames)), want)


def test_loss_matches(models):
    jmodel, jparams, tmodel = models
    batch = _batch(1, 2, 16, labels=True)
    jloss, jmetrics = jmodel.loss(jparams, _jax(batch))
    with torch.no_grad():
        loss, metrics = tmodel.loss(_torch(batch))
    assert set(metrics) == set(jmetrics) == {"xent"}
    _close(loss, jloss)


def test_gradients_match(models):
    """Every leaf's gradient: both stacks, the position tables, the
    embedding and the norms."""
    jmodel, jparams, tmodel = models
    batch = _batch(2, 2, 16, labels=True)
    jgrads = jax.grad(lambda p: jmodel.loss(p, _jax(batch))[0])(jparams)
    want = encdec_params_from_jax(jax.tree.map(np.asarray, jgrads))
    tmodel.zero_grad()
    tmodel.loss(_torch(batch))[0].backward()
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        _close(p.grad, want[name].numpy())
    tmodel.zero_grad(set_to_none=True)


@pytest.mark.parametrize("pos0", [0, 5])
def test_prefill_logits_and_caches_match(models, pos0):
    jmodel, jparams, tmodel = models
    batch = _batch(3, 3, 11)
    jlogits, jcaches = jmodel.prefill(jparams, _jax(batch), pos0)
    with torch.no_grad():
        logits, caches = tmodel.prefill(_torch(batch), pos0)
    assert logits.shape == (3, 1, padded_vocab(512))
    _close(logits, jlogits)
    for part in ("self", "cross"):
        jk, jv = jcaches[part]             # (L, B, S, H, dh)
        assert len(caches[part]) == jk.shape[0]
        for i, (k, v) in enumerate(caches[part]):
            _close(k, jk[i])
            _close(v, jv[i])


def test_decode_steps_match(models):
    """Prefill 12 tokens, copy the self K/V into a 20-long cache with
    init_cache(prefix=) (the cross K/V are the prefill's), then 4 greedy
    decode steps: every step's logits and the final self caches agree."""
    jmodel, jparams, tmodel = models
    batch = _batch(4, 2, 12)
    jlogits, jpre = jmodel.prefill(jparams, _jax(batch))
    jinit = jmodel.init_cache(2, 20)
    jcache = {"self": jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice_in_dim(
            dst, src.astype(dst.dtype), 0, axis=2),
        jinit["self"], jpre["self"]), "cross": jpre["cross"]}
    with torch.no_grad():
        logits, pre = tmodel.prefill(_torch(batch))
        cache = tmodel.init_cache(2, 20, prefix=pre)
        assert cache["self"][0][0].shape == (2, 20, 4, 32)
        assert cache["cross"] is pre["cross"]
        jtok = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        for step in range(4):
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            jl, jcache = jmodel.decode_step(jparams, jcache, jtok,
                                            jnp.asarray(12 + step, jnp.int32))
            lg, cache = tmodel.decode_step(cache, tok, 12 + step)
            _close(lg, jl)
            jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
            tok = lg.argmax(dim=-1)[:, None]
    jk, jv = jcache["self"]
    for i, (k, v) in enumerate(cache["self"]):
        _close(k, jk[i])
        _close(v, jv[i])


def test_init_cache_without_prefix_is_zeros(models):
    _, _, tmodel = models
    cache = tmodel.init_cache(2, 9)
    assert set(cache) == {"self", "cross"}
    assert len(cache["self"]) == len(cache["cross"]) == 2
    assert cache["self"][1][1].shape == (2, 9, 4, 32)
    assert cache["cross"][0][0].shape == (2, 64, 4, 32)
    assert not any(t.any() for part in cache.values() for pair in part
                   for t in pair)
