"""MLA and the flash kernel's head_dim 192 on the CPU: the JAX package's
Pallas flash kernel (interpret mode) at deepseek-v3's qk head_dim against
the port's plain version (2e-3 in float32, 2e-2 in bfloat16, the kernel
test's tolerances); ``check_inputs`` and ``select_path`` at 192 and at the
kernel's limits; ``mla_forward`` against the JAX package's (prefill and
decode, rtol 1e-4), and its absorbed decode against the expanded
prefill."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MLAConfig as JaxMLAConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.models import attention as jattn
from repro_torch.configs import get_model_config, smoke_config
from repro_torch.configs.base import MLAConfig
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MLA_DH = 192      # deepseek-v3: qk_nope 128 + qk_rope 64


def test_deepseek_qk_head_dim_is_192():
    m = get_model_config("deepseek-v3-671b").mla
    assert m.qk_nope_head_dim + m.qk_rope_head_dim == MLA_DH


@pytest.mark.parametrize("bh,bhkv,sq,skv,causal", [
    (2, 2, 128, 128, True),
    (4, 4, 256, 256, True),
    (2, 1, 128, 256, False),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_matches_jax_kernel_at_head_dim_192(bh, bhkv, sq, skv, causal,
                                                dtype):
    jdt, tdt, tol = DTYPES[dtype]
    r = np.random.RandomState(bh + sq)
    arrays = (r.randn(bh, sq, MLA_DH).astype(np.float32),
              r.randn(bhkv, skv, MLA_DH).astype(np.float32),
              r.randn(bhkv, skv, MLA_DH).astype(np.float32))
    want = flash_attention_fwd(*(jnp.asarray(a, jdt) for a in arrays),
                               causal=causal, interpret=True)
    mine = attention_ref(*(torch.from_numpy(a).to(tdt) for a in arrays),
                         causal)
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _qkv(dh, dtype, s=8):
    q = torch.zeros(2, s, 4, dh, dtype=dtype)
    return q, torch.zeros(2, s, 2, dh, dtype=dtype), \
        torch.zeros(2, s, 2, dh, dtype=dtype)


@pytest.mark.parametrize("dtype,dh,path", [
    (torch.bfloat16, 192, "tc"), (torch.float32, 192, "simt"),
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 160, "simt"),
])
def test_select_path_and_check_inputs(dtype, dh, path):
    """bf16 at head_dim 192 takes the tensor cores, as at 64 and 128;
    every other head_dim up to 256 the CUDA cores; the check looks at
    types, shapes and strides only, so it runs on the CPU."""
    assert kernel.select_path(dtype, dh) == path
    assert kernel.check_inputs(*_qkv(dh, dtype)) == path


def test_check_inputs_refuses_past_256():
    assert kernel.MAX_HEAD_DIM == 256
    with pytest.raises(ValueError, match="head_dim <= 256"):
        kernel.check_inputs(*_qkv(264, torch.float32))


def test_check_inputs_takes_mla_prefill_tensors():
    """MLA's expanded prefill hands the kernel concatenated q and k and a
    padded v, all contiguous: TMA's alignment and strides hold."""
    cfg = get_model_config("deepseek-v3-671b")
    m, h = cfg.mla, 8
    b, s = 1, 5
    q = torch.cat([torch.zeros(b, s, h, m.qk_nope_head_dim),
                   torch.zeros(b, s, h, m.qk_rope_head_dim)], dim=-1)
    kr = torch.zeros(b, s, m.qk_rope_head_dim)
    k = torch.cat([torch.zeros(b, s, h, m.qk_nope_head_dim),
                   kr[:, :, None].expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    v = torch.nn.functional.pad(torch.zeros(b, s, h, m.v_head_dim),
                                (0, MLA_DH - m.v_head_dim))
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    assert kernel.check_inputs(*bf) == "tc"


# ranks unlike the smoke config's, so a swapped dimension shows
_MLA = dict(q_lora_rank=48, kv_lora_rank=24, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=12)
CFG = smoke_config("deepseek-v3-671b").with_overrides(mla=MLAConfig(**_MLA))


@pytest.fixture(scope="module")
def mla():
    jcfg = jax_smoke_config("deepseek-v3-671b").with_overrides(
        mla=JaxMLAConfig(**_MLA))
    jp = jattn.init_mla(jax.random.PRNGKey(3), jcfg, jnp.float32)
    # a norm weight away from 1, so a missed norm shows
    jp["kv_norm"] = jp["kv_norm"] * 1.5
    tp = tattn.init_mla(CFG, torch.Generator().manual_seed(0),
                        torch.float32)
    tp.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in jp.items()}, strict=True)
    return jcfg, jp, tp


def _close(mine, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(mine.detach().float().numpy(), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_mla_prefill_and_decode_match_jax(mla):
    """The expanded prefill with v padded to the qk width (output and the
    latent cache), then 3 absorbed decode steps over a 16-long cache."""
    jcfg, jp, tp = mla
    x = np.random.RandomState(0).randn(2, 9, 128).astype(np.float32)
    pos = np.arange(9)
    jy, jkv = jattn.mla_forward(jp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos), return_kv=True)
    with torch.no_grad():
        y, kv = tattn.mla_forward(tp, torch.from_numpy(x), CFG,
                                  positions=torch.from_numpy(pos),
                                  return_kv=True)
    _close(y, jy)
    for mine, want in zip(kv, jkv):
        _close(mine, want)
    jc = tuple(jnp.zeros((2, 16, n)).at[:, :9].set(w)
               for n, w in zip((24, 8), jkv))
    tc = tuple(torch.zeros(2, 16, n) for n in (24, 8))
    for dst, src in zip(tc, kv):
        dst[:, :9] = src
    xs = np.random.RandomState(1).randn(3, 2, 1, 128).astype(np.float32)
    for i in range(3):
        jy, jc = jattn.mla_forward(
            jp, jnp.asarray(xs[i]), jcfg, positions=jnp.asarray([9 + i]),
            cache=jc, cache_index=jnp.asarray(9 + i, jnp.int32))
        with torch.no_grad():
            y, tc = tattn.mla_forward(
                tp, torch.from_numpy(xs[i]), CFG,
                positions=torch.tensor([9 + i]), cache=tc,
                cache_index=9 + i)
        _close(y, jy)
    for mine, want in zip(tc, jc):
        _close(mine, want)


def test_mla_decode_matches_the_expanded_prefill(mla):
    """Decoding position t over the first t positions' latents gives the
    expanded prefill's output at t: the absorbed form (q^T W_uk c_kv, and
    W_uv after the softmax) is the same function."""
    _, _, tp = mla
    x = torch.from_numpy(
        np.random.RandomState(2).randn(3, 11, 128).astype(np.float32))
    with torch.no_grad():
        y, (c, r) = tattn.mla_forward(tp, x, CFG,
                                      positions=torch.arange(11),
                                      return_kv=True)
        cache = (torch.zeros(3, 11, 24), torch.zeros(3, 11, 8))
        cache[0][:, :10], cache[1][:, :10] = c[:, :10], r[:, :10]
        yd, cache = tattn.mla_forward(tp, x[:, 10:], CFG,
                                      positions=torch.tensor([10]),
                                      cache=cache, cache_index=10)
    torch.testing.assert_close(yd[:, 0], y[:, 10], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cache[0], c)
    torch.testing.assert_close(cache[1], r)
