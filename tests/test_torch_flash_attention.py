"""The port's flash attention (plain version, autograd op, dispatch) against
the JAX package's Pallas kernel (interpret mode) and its oracle, on the
CPU, with inputs made from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, bh, bhkv, sq, skv, dh):
    r = np.random.RandomState(seed)
    return (r.randn(bh, sq, dh).astype(np.float32),
            r.randn(bhkv, skv, dh).astype(np.float32),
            r.randn(bhkv, skv, dh).astype(np.float32))


def _port(arrays, tdt, causal):
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    return attention_ref(q, k, v, causal).float().numpy()


@pytest.mark.parametrize("bh,bhkv,sq,skv,dh,causal", [
    (2, 2, 128, 128, 64, True),
    (4, 2, 256, 256, 64, True),
    (4, 1, 128, 256, 128, False),
    (8, 4, 384, 384, 64, True),
    (4, 2, 128, 256, 128, True),      # Sq < Skv: pins top-left causal
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_matches_jax_kernel(bh, bhkv, sq, skv, dh, causal, dtype):
    """The grid of the JAX package's kernel test; tolerance as there."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _qkv(bh + sq, bh, bhkv, sq, skv, dh)
    want = flash_attention_fwd(*(jnp.asarray(a, jdt) for a in arrays),
                               causal=causal, block_q=128, block_k=128,
                               interpret=True)
    np.testing.assert_allclose(_port(arrays, tdt, causal),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,bhkv,sq,skv,dh,causal", [
    (15, 3, 100, 100, 64, True),      # the JAX kernel asserts S % 128 == 0
    (6, 2, 33, 77, 40, False),
    (4, 2, 5, 300, 16, True),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_matches_jax_oracle_at_ragged_shapes(bh, bhkv, sq, skv, dh,
                                                 causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _qkv(sq, bh, bhkv, sq, skv, dh)
    want = jax_ref(*(jnp.asarray(a, jdt) for a in arrays), causal=causal)
    np.testing.assert_allclose(_port(arrays, tdt, causal),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _model_layout(seed):
    r = np.random.RandomState(seed)
    return (r.randn(1, 128, 4, 64).astype(np.float32),
            r.randn(1, 128, 2, 64).astype(np.float32),
            r.randn(1, 128, 2, 64).astype(np.float32))


def test_op_and_gradients_match_jax_vjp():
    """The JAX package's VJP test shape, loss sum(out ** 2): forward within
    the kernel test's fp32 tolerance, gradients rtol 1e-4."""
    arrays = _model_layout(0)
    j_out = jax_flash(*(jnp.asarray(a) for a in arrays))
    j_grads = jax.grad(lambda q, k, v: jnp.sum(jax_flash(q, k, v) ** 2),
                       argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = flash_attention(*ts)
    assert out.shape == (1, 128, 4, 64)
    grads = torch.autograd.grad((out ** 2).sum(), ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=2e-3, atol=2e-3)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)


def test_op_on_cpu_is_the_plain_version_and_never_the_kernel():
    q, k, v = (torch.from_numpy(a) for a in _model_layout(1))
    before = kernel.launches
    out = flash_attention(q, k, v, causal=False)
    assert kernel.launches == before
    fold = [t.transpose(1, 2).reshape(-1, 128, 64) for t in (q, k, v)]
    want = attention_ref(*fold, causal=False).reshape(1, 4, 128, 64)
    torch.testing.assert_close(out, want.transpose(1, 2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        kernel.flash_attention_fwd(*fold)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(*(t.to("meta") for t in (q, k, v)))


def _strided(arrays, hq, hkv):
    """q, k, v as slices of one (B, S, (Hq + 2 Hkv) * dh) projection, the
    layout a fused qkv projection gives the kernel: not contiguous."""
    q, k, v = arrays
    b, s, _, dh = q.shape
    proj = torch.from_numpy(np.concatenate(
        [a.reshape(b, s, -1) for a in (q, k, v)], axis=-1))
    parts = (proj[..., :hq * dh], proj[..., hq * dh:(hq + hkv) * dh],
             proj[..., (hq + hkv) * dh:])
    return [p.unflatten(-1, (-1, dh)) for p in parts]


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal", [
    (2, 128, 4, 2, 64, True),
    (1, 100, 12, 1, 128, True),       # starcoder2-3b's group of 12
    (2, 64, 8, 2, 32, False),
])
def test_op_on_strided_inputs_matches_jax_kernel_and_vjp(b, s, hq, hkv, dh,
                                                         causal):
    """The op reads (B, S, H, dh) slices in place: forward against the JAX
    op (the Pallas kernel in interpret mode) within the kernel test's fp32
    tolerance, gradients against its VJP at rtol 1e-4."""
    r = np.random.RandomState(s + hq)
    arrays = [r.randn(b, s, h, dh).astype(np.float32)
              for h in (hq, hkv, hkv)]
    ts = [t.requires_grad_() for t in _strided(arrays, hq, hkv)]
    assert not any(t.is_contiguous() for t in ts)
    out = flash_attention(*ts, causal=causal)
    grads = torch.autograd.grad((out ** 2).sum(), ts)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal) ** 2)
    j_out = jax_flash(*(jnp.asarray(a) for a in arrays), causal)
    j_grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    assert out.shape == (b, s, hq, dh)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=2e-3, atol=2e-3)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype,dh,path", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 96, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 64, "simt"),
])
def test_select_path_by_type_and_head_dim(dtype, dh, path):
    assert kernel.select_path(dtype, dh) == path


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 40)])
def test_check_inputs_takes_the_models_layouts(dtype, dh):
    """Contiguous (B, S, H, dh) tensors and slices of a wider projection
    pass, with the path select_path gives; no card needed."""
    proj = torch.zeros(2, 48, (12 + 2) * dh, dtype=dtype)
    q = proj[..., :12 * dh].unflatten(-1, (12, dh))
    k = proj[..., 12 * dh:13 * dh].unflatten(-1, (1, dh))
    v = proj[..., 13 * dh:].unflatten(-1, (1, dh))
    want = kernel.select_path(dtype, dh)
    assert kernel.check_inputs(q, k, v) == want
    assert kernel.check_inputs(*(t.contiguous() for t in (q, k, v))) == want
    # one row, one head, batch 1: the unused strides are never checked
    one = torch.zeros(1, 1, 1, dh, dtype=dtype)
    assert kernel.check_inputs(one, one, one) == want


def _refused(case):
    q = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    if case == "type":
        return q.double(), kv.double(), kv.double()
    if case == "mixed types":
        return q, kv.float(), kv.float()
    if case == "folded":
        return q[0], kv[0], kv[0]
    if case == "groups":
        kv3 = torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16)
        return q, kv3, kv3
    if case == "batch":
        return q, kv[:1], kv[:1]
    if case == "head_dim":
        big = torch.zeros(1, 4, 1, 264, dtype=torch.bfloat16)
        return big, big, big
    if case == "empty":
        return q[:, :0], kv, kv
    if case == "head dim strided":
        return q.transpose(1, 3).contiguous().transpose(1, 3), kv, kv
    if case == "unaligned":                 # bf16 at dh 64: TMA's 16 bytes
        wide = torch.zeros(2, 16, 4, 65, dtype=torch.bfloat16)
        return wide[..., 1:], kv, kv
    raise AssertionError(case)


@pytest.mark.parametrize("case,match", [
    ("type", "float32 or"), ("mixed types", "float32 or"),
    ("folded", "want \\(B, S, H, dh\\)"), ("groups", "shapes disagree"),
    ("batch", "shapes disagree"), ("head_dim", "head_dim <= 256"),
    ("empty", "non-empty"), ("head dim strided", "not contiguous"),
    ("unaligned", "TMA"),
])
def test_check_inputs_refuses_what_the_kernel_does_not_take(case, match):
    with pytest.raises(ValueError, match=match):
        kernel.check_inputs(*_refused(case))
