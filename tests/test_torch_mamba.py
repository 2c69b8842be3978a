"""The port's Mamba block against the JAX package's, on the CPU: the same
weights (the JAX leaves loaded into the port's module), the same
numpy-seeded inputs. A prefill's output and returned conv and ssm states,
and decode steps from a random cache, which the port updates in place. The
reference prefill scans with ``associative_scan`` over the materialized
(B, S, d_inner, n) tensor, the port with the sequential plain scan: the
same float32 sums in another order, so rtol 1e-4 / atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import mamba as jmb
from repro_torch.configs import smoke_config
from repro_torch.models import mamba as tmb

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "jamba-v0.1-52b"


def _close(mine, want):
    np.testing.assert_allclose(mine.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _block(seed):
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jp = jmb.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = tmb.Mamba(cfg, torch.Generator().manual_seed(0), torch.float32)
    tp.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()}, strict=True)
    return jcfg, jp, cfg, tp


def _x(seed, b, s, d):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def test_dims_and_leaves_match():
    jcfg, jp, cfg, tp = _block(0)
    assert tmb._dims(cfg) == jmb._dims(jcfg) == (256, 8, 4, 8)
    mine = {k: tuple(v.shape) for k, v in tp.state_dict().items()}
    assert mine == {k: tuple(v.shape) for k, v in jp.items()}
    _close(tp.A_log, jp["A_log"])          # log(1..n), as initialized


@pytest.mark.parametrize("s", [64, 13])
def test_prefill_output_and_state_match(s):
    jcfg, jp, cfg, tp = _block(s)
    x = _x(s, 2, s, cfg.d_model)
    jy, jst = jmb.mamba_forward(jp, jnp.asarray(x), jcfg, return_state=True)
    with torch.no_grad():
        y, st = tmb.mamba_forward(tp, torch.from_numpy(x), cfg,
                                  return_state=True)
    _close(y, jy)
    assert set(st) == {"conv", "ssm"}
    for name in st:
        assert st[name].shape == jst[name].shape
        _close(st[name], jst[name])
    with torch.no_grad():
        y2, none = tmb.mamba_forward(tp, torch.from_numpy(x), cfg)
    assert none is None
    torch.testing.assert_close(y2, y, rtol=0, atol=0)


def test_decode_steps_match_and_update_the_cache_in_place():
    """Four decode steps from a random cache, each output and the cache's
    conv and ssm leaves after each step."""
    jcfg, jp, cfg, tp = _block(3)
    di, n, dc, _ = tmb._dims(cfg)
    r = np.random.RandomState(7)
    conv = r.randn(2, dc - 1, di).astype(np.float32)
    ssm = r.randn(2, di, n).astype(np.float32)
    jcache = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    cache = {"conv": torch.from_numpy(conv.copy()),
             "ssm": torch.from_numpy(ssm.copy())}
    leaves = dict(cache)
    for step in range(4):
        x = _x(10 + step, 2, 1, cfg.d_model)
        jy, jcache = jmb.mamba_forward(jp, jnp.asarray(x), jcfg,
                                       cache=jcache)
        with torch.no_grad():
            y, c = tmb.mamba_forward(tp, torch.from_numpy(x), cfg,
                                     cache=cache)
        assert c is cache and all(c[k] is leaves[k] for k in leaves)
        _close(y, jy)
        for name in ("conv", "ssm"):
            _close(cache[name], jcache[name])


def test_prefill_then_decode_continue_the_sequence():
    """A prefill of 20 tokens whose states seed a decode of the 21st gives
    the 21st output of a 21-token prefill (both packages alike)."""
    jcfg, jp, cfg, tp = _block(5)
    x = _x(5, 2, 21, cfg.d_model)
    full, _ = tmb.mamba_forward(tp, torch.from_numpy(x), cfg)
    with torch.no_grad():
        _, st = tmb.mamba_forward(tp, torch.from_numpy(x[:, :20]), cfg,
                                  return_state=True)
        last, _ = tmb.mamba_forward(tp, torch.from_numpy(x[:, 20:]), cfg,
                                    cache=st)
    _close(last, full[:, 20:].detach().numpy())
    jfull, _ = jmb.mamba_forward(jp, jnp.asarray(x), jcfg)
    _close(last, jfull[:, 20:])


def test_init_mamba_cache_matches():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    want = jmb.init_mamba_cache(jcfg, 3, jnp.bfloat16)
    mine = tmb.init_mamba_cache(cfg, 3, torch.bfloat16, torch.device("cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), torch.bfloat16) for k, v in want.items()}
    assert all(not v.any() for v in mine.values())
