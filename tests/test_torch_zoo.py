"""The rest of the decoder-only zoo against the JAX package's
``TransformerLM`` on the CPU, at smoke size: the dense GQA archs
mistral-nemo-12b, internlm2-20b, qwen2-72b (qkv bias), llava-next-34b with
16 image patches in front of the tokens, and deepseek-v3-671b (MLA, top-2
of 8 experts plus a shared one, the MTP head). Same converted weights, same
numpy-seeded tokens and patches: prefill logits and every cache leaf,
decode steps through ``init_cache(prefix=)``, the loss with its ``aux``
(and ``mtp``) metrics, and the gradients of ``embed`` and of the first
layer's mixer. Tolerance rtol 1e-4 and atol 1e-5 relative to the largest
|value|, as ``test_torch_moe_archs.py``: float32 sums taken in another
order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro_torch.configs import smoke_config
from repro_torch.models.convert import transformer_params_from_jax
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model_zoo import build_model

ARCHS = ("mistral-nemo-12b", "internlm2-20b", "qwen2-72b", "llava-next-34b",
         "deepseek-v3-671b")
PATCHES = 16


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


def _batch(cfg, seed, b, s, labels=False):
    """numpy tokens (and labels, and llava's patches): the same arrays go
    to both packages."""
    r = np.random.RandomState(seed)
    out = {"tokens": r.randint(0, 512, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = r.randint(0, 512, (b, s)).astype(np.int32)
        out["labels"][0, :3] = -1          # ignored positions
    if cfg.frontend == "image_patches":
        out["patches"] = r.randn(b, PATCHES, cfg.d_model).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32
                               else torch.float32)
            for k, v in batch.items()}


def _same_caches(caches, jcaches):
    """Port: one pair per layer (K/V, or MLA's c_kv and k_rope); JAX: one
    per pattern entry, each leaf stacked over periods."""
    period = len(jcaches)
    for i, c in enumerate(caches):
        want = jcaches[i % period]["mixer"]
        assert len(c) == len(want) == 2
        for mine, w in zip(c, want):
            _close(mine, w[i // period])


def test_prefill_logits_and_caches_match(models):
    jmodel, jparams, tmodel = models
    batch = _batch(tmodel.cfg, 1, 3, 21)
    jlogits, jcaches = jmodel.prefill(jparams, _jax(batch), 5)
    with torch.no_grad():
        logits, caches = tmodel.prefill(_torch(batch), 5)
    assert logits.shape == (3, 1, padded_vocab(512))
    _close(logits, jlogits)
    _same_caches(caches, jcaches)


def test_decode_steps_match(models):
    """Prefill 12 tokens (after 16 patches for llava), copy the prefill's
    caches into a longer cache with init_cache(prefix=), then 4 greedy
    decode steps: the logits of every step and the final caches agree."""
    jmodel, jparams, tmodel = models
    batch = _batch(tmodel.cfg, 3, 2, 12)
    width = 12 + (PATCHES if "patches" in batch else 0)
    jlogits, jpre = jmodel.prefill(jparams, _jax(batch))
    jcache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice_in_dim(
            dst, src.astype(dst.dtype), 0, axis=2),
        jmodel.init_cache(2, width + 8), jpre)
    with torch.no_grad():
        logits, pre = tmodel.prefill(_torch(batch))
        cache = tmodel.init_cache(2, width + 8, prefix=pre)
        _same_caches(cache, jcache)
        jtok = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        for step in range(4):
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            jl, jcache = jmodel.decode_step(
                jparams, jcache, jtok, jnp.asarray(width + step, jnp.int32))
            lg, cache = tmodel.decode_step(cache, tok, width + step)
            _close(lg, jl)
            jtok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
            tok = lg.argmax(dim=-1)[:, None]
    _same_caches(cache, jcache)


def test_loss_and_metrics_match(models):
    jmodel, jparams, tmodel = models
    cfg = tmodel.cfg
    batch = _batch(cfg, 5, 2, 16, labels=True)
    jloss, jmetrics = jmodel.loss(jparams, _jax(batch))
    with torch.no_grad():
        loss, metrics = tmodel.loss(_torch(batch))
    want = {"xent", "aux"} | ({"mtp"} if cfg.mtp_depth else set())
    assert set(metrics) == set(jmetrics) == want
    _close(loss, jloss)
    for name in want:
        _close(metrics[name], jmetrics[name])
    total = metrics["xent"] + metrics["aux"]
    if cfg.mtp_depth:
        total = total + 0.3 * metrics["mtp"]
    torch.testing.assert_close(loss, total)


def test_gradients_match(models):
    """d loss / d embed and d loss / d (every leaf of layer 0's mixer)."""
    jmodel, jparams, tmodel = models
    batch = _batch(tmodel.cfg, 7, 2, 16, labels=True)
    jgrads = jax.grad(lambda p: jmodel.loss(p, _jax(batch))[0])(jparams)
    want = transformer_params_from_jax(jax.tree.map(np.asarray, jgrads))
    tmodel.zero_grad()
    tmodel.loss(_torch(batch))[0].backward()
    got = dict(tmodel.named_parameters())
    names = ["embed"] + [n for n in got if n.startswith("layers.0.mixer.")]
    assert len(names) > 4
    for name in names:
        _close(got[name].grad, want[name].numpy())
    tmodel.zero_grad(set_to_none=True)
