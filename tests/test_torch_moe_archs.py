"""The two MoE archs this slice brings, as whole models, against the JAX
package's ``TransformerLM`` on the CPU: jamba-v0.1-52b at smoke size (16
layers in two periods of the mamba/attention pattern, 8 experts top-2) and
qwen2-moe-a2.7b at smoke size (GQA with qkv bias, top-2 of 8 experts plus
4 shared). Same converted weights, same numpy-seeded tokens: prefill
logits and every cache leaf, decode steps through ``init_cache(prefix=)``,
and the loss with its aux term. Tolerance rtol 1e-4 and atol 1e-5 relative
to the largest |value|: float32 sums taken in another order, and the
reference's expert init (std 0.25) makes the residual stream grow."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro_torch.configs import smoke_config
from repro_torch.configs.base import BlockKind as BK
from repro_torch.models.convert import transformer_params_from_jax
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model_zoo import build_model

ARCHS = ("jamba-v0.1-52b", "qwen2-moe-a2.7b")


def _close(mine, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(mine.detach().float().numpy(), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jmodel = jax_build_model(jax_smoke_config(arch), JaxRuntime())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(smoke_config(arch), device="cpu", seed=1)
    tmodel.load_state_dict(transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, tmodel.eval()


def _tokens(seed, b, s):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(
        np.int32)


def _same_caches(caches, jcaches):
    """Port: one entry per layer; JAX: one per pattern entry, each leaf
    stacked over periods (layer i is period i // P of entry i % P)."""
    period = len(jcaches)
    for i, c in enumerate(caches):
        jc = jcaches[i % period]
        if isinstance(c, dict):            # mamba: {"mixer": {conv, ssm}}
            assert set(c) == {"mixer", "ffn"} and c["ffn"] == {}
            assert set(c["mixer"]) == {"conv", "ssm"} == set(jc["mixer"])
            for name, leaf in c["mixer"].items():
                _close(leaf, jc["mixer"][name][i // period])
        else:
            for mine, want in zip(c, jc["mixer"]):
                _close(mine, want[i // period])


def test_layers_follow_the_pattern(models):
    _, _, tmodel = models
    cfg = tmodel.cfg
    kinds = [layer.kinds for layer in tmodel.layers]
    assert kinds == [cfg.pattern[i % len(cfg.pattern)]
                     for i in range(cfg.num_layers)]
    assert all(k[1] == BK.MOE_FFN for k in kinds[1::2])
    assert tmodel.layers[1].ffn.router.dtype == torch.float32


@pytest.mark.parametrize("s", [24, 9])
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
    """Prefill 12 tokens, copy the prefill's caches into a 20-long cache
    with init_cache(prefix=), then 4 greedy decode steps: the logits of
    every step and the final caches agree."""
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
        _same_caches(cache, jcache)
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
    _same_caches(cache, jcache)


def test_loss_and_aux_match(models):
    jmodel, jparams, tmodel = models
    toks = _tokens(5, 2, 16)
    labels = _tokens(6, 2, 16)
    labels[0, :3] = -1                     # ignored positions
    jloss, jmetrics = jmodel.loss(jparams, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)})
    with torch.no_grad():
        loss, metrics = tmodel.loss(
            {"tokens": torch.as_tensor(toks, dtype=torch.long),
             "labels": torch.as_tensor(labels, dtype=torch.long)})
    assert set(metrics) == {"xent", "aux"}
    assert metrics["aux"].item() > 0
    _close(loss, jloss)
    for name in ("xent", "aux"):
        _close(metrics[name], jmetrics[name])
    torch.testing.assert_close(loss, metrics["xent"] + metrics["aux"])
