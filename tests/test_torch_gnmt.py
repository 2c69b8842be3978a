"""The port's GNMT against the JAX package's: same converted weights, same
numpy-seeded batches; loss and every gradient leaf, on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.models.rnn import GNMT as JaxGNMT
from repro.models.rnn import GNMTConfig as JaxGNMTConfig
from repro_torch.models.convert import gnmt_params_from_jax
from repro_torch.models.rnn import GNMT, GNMTConfig

SMALL = dict(vocab_size=256, d_model=32, num_enc_uni=2, num_dec=2)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGNMT(JaxGNMTConfig(**SMALL))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = GNMT(GNMTConfig(**SMALL), seed=1, device="cpu")
    tmodel.load_state_dict(
        gnmt_params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    return jmodel, jparams, tmodel


@pytest.mark.parametrize("seed,bsz,src_len,tgt_len,pad", [
    (3, 4, 9, 11, 0),        # longer target than source
    (5, 3, 12, 7, 4),        # the last 4 source positions padded (id 0)
])
def test_loss_and_every_gradient_match_jax(models, seed, bsz, src_len,
                                           tgt_len, pad):
    """Loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 (fp32 sums taken
    over time in another order)."""
    jmodel, jparams, tmodel = models
    jbatch = {k: np.array(v) for k, v in
              jmodel.make_batch(seed, bsz, src_len, tgt_len).items()}
    if pad:
        jbatch["src"][:, -pad:] = 0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)[0]))(jparams, jbatch)
    want = gnmt_params_from_jax(jax.tree.map(np.asarray, jgrads))

    tbatch = {k: torch.as_tensor(v, dtype=torch.long)
              for k, v in jbatch.items()}
    names, params = zip(*tmodel.named_parameters())
    loss, _ = tmodel.loss(tbatch)
    grads = torch.autograd.grad(loss, params)

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_make_batch_draws_the_jax_batch(models):
    jmodel, _, tmodel = models
    jb = jmodel.make_batch(40, 16, 40, 40)
    tb = tmodel.make_batch(40, 16, 40, 40)
    for k in ("src", "tgt", "labels"):
        assert tb[k].dtype == torch.long
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_kernel_layout_parameters_and_init():
    model = GNMT(GNMTConfig(**SMALL), seed=0, device="cpu")
    d = SMALL["d_model"]
    assert model.enc_bi_f.w.shape == (d + d // 2, d // 2, 4)
    assert model.enc_bi_b.b.shape == (d // 2, 4)
    assert model.dec[0].w.shape == (3 * d, d, 4)
    assert model.dec[1].w.shape == (2 * d, d, 4)
    assert not model.dec[0].b.any()
    # dense_init's std is 1/sqrt(fan_in), fan_in = D+H
    std = model.enc_uni[0].w.std().item()
    assert abs(std * np.sqrt(2 * d) - 1.0) < 0.05
    again = GNMT(GNMTConfig(**SMALL), seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_plain_cell_path_gives_the_same_loss(models):
    _, _, tmodel = models
    batch = tmodel.make_batch(8, 2, 6, 5)
    loss_k = tmodel.loss(batch)[0]
    tmodel.use_kernel = False
    try:
        loss_p = tmodel.loss(batch)[0]
    finally:
        tmodel.use_kernel = True
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-6, atol=0)
