"""The port's decoder-only LM against the JAX package's: same converted
weights, same numpy-seeded tokens; prefill logits and K/V caches, decode
steps and the loss, on the CPU. Tolerance rtol 1e-4 / atol 1e-5: float32
sums are taken in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_model_config, list_archs, smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models.convert import transformer_params_from_jax
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import apply_rope, padded_vocab, rms_norm
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime, TransformerLM

TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("starcoder2-3b").with_overrides(**TINY)
    jmodel = jax_build_model(jcfg, JaxRuntime())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = smoke_config("starcoder2-3b").with_overrides(**TINY)
    tmodel = build_model(cfg, Runtime(), device="cpu", seed=1)
    tmodel.load_state_dict(transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, tmodel.eval()


def _tokens(seed, b, s):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _close(mine, want):
    np.testing.assert_allclose(mine.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("pos0", [0, 7])
def test_prefill_logits_and_caches_match(models, pos0):
    jmodel, jparams, tmodel = models
    toks = _tokens(pos0, 3, 21)
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                      pos0)
    with torch.no_grad():
        logits, caches = tmodel.prefill(
            {"tokens": torch.as_tensor(toks, dtype=torch.long)}, pos0)
    assert logits.shape == (3, 1, padded_vocab(256))
    _close(logits, jlogits)
    jk, jv = jcaches[0]["mixer"]           # (n_periods, B, S, Hkv, dh)
    assert len(caches) == jk.shape[0]
    for i, (k, v) in enumerate(caches):
        _close(k, jk[i])
        _close(v, jv[i])


def test_decode_steps_match(models):
    """Prefill 12 tokens into a 20-long cache, then 4 greedy decode steps
    through init_cache and decode_step; the logits of every step agree."""
    jmodel, jparams, tmodel = models
    toks = _tokens(3, 2, 12)
    jlogits, jpre = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    jcache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice_in_dim(
            dst, src.astype(dst.dtype), 0, axis=2),
        jmodel.init_cache(2, 20), jpre)
    with torch.no_grad():
        logits, pre = tmodel.prefill(
            {"tokens": torch.as_tensor(toks, dtype=torch.long)})
        cache = tmodel.init_cache(2, 20, prefix=pre)
        assert cache[0][0].shape == (2, 20, 2, 32)
        for (k, v), (jk, jv) in zip(cache, zip(*jcache[0]["mixer"])):
            _close(k, jk)                  # prefix in front, zeros behind
            _close(v, jv)
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
    jk, jv = jcache[0]["mixer"]
    for i, (k, v) in enumerate(cache):
        _close(k, jk[i])
        _close(v, jv[i])


def test_loss_matches(models):
    jmodel, jparams, tmodel = models
    toks = _tokens(5, 2, 16)
    labels = _tokens(6, 2, 16)
    labels[0, :3] = -1                     # ignored positions
    jloss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
    with torch.no_grad():
        loss, metrics = tmodel.loss(
            {"tokens": torch.as_tensor(toks, dtype=torch.long),
             "labels": torch.as_tensor(labels, dtype=torch.long)})
    _close(loss, jloss)
    assert set(metrics) == {"xent", "aux"}


def _qkv(seed, b, sq, skv, hq, hkv, dh):
    r = np.random.RandomState(seed)
    return (r.randn(b, sq, hq, dh).astype(np.float32),
            r.randn(b, skv, hkv, dh).astype(np.float32),
            r.randn(b, skv, hkv, dh).astype(np.float32))


@pytest.mark.parametrize("chunk,causal", [(0, True), (16, True), (16, False),
                                          (8, False)])
def test_attention_core_matches(chunk, causal):
    """The plain dispatch (full or chunked, GQA repeat) on the CPU."""
    arrays = _qkv(chunk, 2, 32, 32, 4, 2, 16)
    want = jattn.attention_core(*(jnp.asarray(a) for a in arrays),
                                causal=causal, chunk=chunk)
    mine = tattn.attention_core(*(torch.from_numpy(a) for a in arrays),
                                causal=causal, chunk=chunk)
    _close(mine, want)


def test_gqa_decode_attention_matches():
    arrays = _qkv(9, 3, 1, 24, 6, 2, 16)
    valid = np.array([5, 24, 13], np.int32)
    want = jattn.gqa_decode_attention(*(jnp.asarray(a) for a in arrays),
                                      jnp.asarray(valid))
    mine = tattn.gqa_decode_attention(*(torch.from_numpy(a) for a in arrays),
                                      torch.as_tensor(valid, dtype=torch.long))
    _close(mine, want)


def test_rope_and_rms_norm_match():
    from repro.models import layers as jl
    r = np.random.RandomState(2)
    x = r.randn(2, 9, 3, 16).astype(np.float32)
    pos = np.arange(4, 13)
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 999_999.4),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 999_999.4))
    w = r.randn(16).astype(np.float32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_build_model_refuses_what_this_slice_lacks():
    """The port lacks no arch now: every arch of list_archs() builds at
    smoke size on the CPU, whisper as the encoder-decoder; only a card
    that is not there is refused."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(smoke_config("starcoder2-3b"))
    for arch in list_archs():
        cfg = smoke_config(arch)
        m = build_model(cfg, device="cpu")
        if cfg.encoder is not None:
            assert isinstance(m, EncDecLM)
            assert len(m.enc_layers) == cfg.encoder.num_layers
            assert len(m.dec_layers) == cfg.num_layers
        else:
            assert isinstance(m, TransformerLM)
            assert len(m.layers) == cfg.num_layers
            assert hasattr(m, "mtp") == bool(cfg.mtp_depth)
    full = get_model_config("starcoder2-3b")
    assert (full.num_layers, full.d_model, full.resolved_head_dim) == \
        (30, 3072, 128)
