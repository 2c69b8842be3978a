"""The port's single-device MoE against the JAX package's (no mesh), on the
CPU: the same weights, the same numpy-seeded tokens. Routing (probabilities,
gates, the chosen experts exactly), each assignment's rank within its
expert, the capacity and the tokens it drops, and the layer's output and
aux loss with and without shared experts. Tolerance rtol 1e-4 and atol
1e-5 relative to the largest |value|: float32 sums taken in another order,
and the reference draws expert weights with std 0.25 (``dense_init`` takes
fan_in from the expert axis), so outputs run to tens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch.configs import smoke_config
from repro_torch.models import moe as tmoe

def _close(mine, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(mine.detach().float().numpy(), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _layer(arch, seed=0):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = tmoe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32)
    tp.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()}, strict=True)
    return jcfg, jp, cfg, tp


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("t", [1, 4, 7, 64, 100, 1000, 6144])
def test_expert_capacity_matches(t):
    for arch in ("jamba-v0.1-52b", "qwen2-moe-a2.7b"):
        assert tmoe.expert_capacity(t, smoke_config(arch)) == \
            jmoe.expert_capacity(t, jax_smoke_config(arch))


def test_route_matches_and_picks_the_same_experts():
    _, jp, _, tp = _layer("jamba-v0.1-52b")
    xt = _x(1, 200, 128)
    jprobs, jgate, jidx = jmoe._route(jnp.asarray(xt), jp["router"], 2)
    probs, gate, eidx = tmoe._route(torch.from_numpy(xt), tp.router, 2)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jidx))
    _close(probs, jprobs)
    _close(gate, jgate)


@pytest.mark.parametrize("seed,tk,e", [(0, 64, 8), (1, 400, 16), (2, 9, 4)])
def test_positions_match(seed, tk, e):
    """Ranks of a token-major flattening within each expert: exact."""
    flat = np.random.RandomState(seed).randint(0, e, tk)
    want = jmoe._positions(jnp.asarray(flat, jnp.int32), e)
    mine = tmoe._positions(torch.as_tensor(flat, dtype=torch.long), e)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(want))


def test_overflowing_expert_drops_the_same_assignments():
    """A router biased towards expert 3 sends every token there first: 64
    tokens against a capacity of 24, so 40 first choices are dropped, and
    which ones (the stable token-major order keeps the first 24) decides
    the output. Output and aux against the JAX package's ``_moe_math``."""
    jcfg, jp, cfg, tp = _layer("jamba-v0.1-52b", seed=2)
    router = np.array(jp["router"])
    router[:, 3] += 0.5
    xt = np.abs(_x(3, 64, 128))              # so x @ router favours 3
    cap = tmoe.expert_capacity(64, cfg)
    _, _, eidx = tmoe._route(torch.from_numpy(xt),
                             torch.from_numpy(router), 2)
    first = (eidx[:, 0] == 3).sum().item()
    assert cap == 24 and first == 64
    pos = tmoe._positions(eidx.reshape(-1), 8).reshape(64, 2)
    kept = (pos < cap)[:, 0]
    assert kept[:cap].all() and not kept[cap:].any()
    jy, jaux = jmoe._moe_math(jnp.asarray(xt), jnp.asarray(router),
                              jp["e_wg"], jp["e_wu"], jp["e_wo"], jcfg)
    y, aux = tmoe._moe_math(torch.from_numpy(xt), torch.from_numpy(router),
                            tp.e_wg, tp.e_wu, tp.e_wo, cfg)
    _close(y, jy)
    _close(aux, jaux)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("b,s", [(2, 24), (4, 1)])
def test_moe_forward_matches(arch, b, s):
    """jamba's MoE (8 experts top-2 at smoke size) and qwen2-moe's (top-2
    plus 4 shared experts), at a prefill shape and a decode step."""
    jcfg, jp, cfg, tp = _layer(arch, seed=b + s)
    assert bool(cfg.moe.num_shared_experts) == (arch == "qwen2-moe-a2.7b")
    x = _x(b * s, b, s, cfg.d_model)
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y, aux = tmoe.moe_forward(tp, torch.from_numpy(x), cfg)
    assert y.shape == (b, s, cfg.d_model) and y.dtype == torch.float32
    _close(y, jy)
    _close(aux, jaux)


def test_router_stays_float32_in_bf16():
    cfg = smoke_config("jamba-v0.1-52b")
    tp = tmoe.MoE(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    assert tp.router.dtype == torch.float32
    assert tp.e_wg.dtype == torch.bfloat16
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jax_smoke_config(
        "jamba-v0.1-52b"), jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32
    x = torch.from_numpy(_x(0, 2, 5, 128)).to(torch.bfloat16)
    with torch.no_grad():
        y, aux = tmoe.moe_forward(tp, x, cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
