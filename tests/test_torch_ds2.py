"""The port's DS2 and Track A's counters against the JAX package's: the same
converted weights and numpy-seeded inputs through the GRU, the frontend,
CTC and the whole DS2 loss and gradient, on the CPU; the machine configs;
and what each package's counts see."""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import rnn as jrnn
from repro.perfmodel import machine as jmachine
from repro_torch.core import reproduction
from repro_torch.core.characterize import count_costs
from repro_torch.core.reproduction import SMALL_DS2, SMALL_GNMT
from repro_torch.models.convert import ds2_params_from_jax
from repro_torch.models.rnn import (
    DS2,
    GRU,
    GNMT,
    DS2Config,
    ctc_loss,
    gru_cell,
    same_out,
)
from repro_torch.perfmodel import machine

CPU = torch.device("cpu")
SMALL = dict(num_freq=SMALL_DS2.num_freq,
             conv_channels=SMALL_DS2.conv_channels, d_h=SMALL_DS2.d_h,
             num_gru=SMALL_DS2.num_gru)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_ds2(jparams, **cfg) -> DS2:
    model = DS2(DS2Config(**cfg), seed=1, device="cpu")
    model.load_state_dict(ds2_params_from_jax(_np(jparams)), strict=True)
    return model


@pytest.fixture(scope="module")
def small_ds2():
    jmodel = jrnn.DS2(jrnn.DS2Config(**SMALL))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, _port_ds2(jparams, **SMALL)


def _gru(d_in, d_h, seed):
    jp = jrnn.init_gru(jax.random.PRNGKey(seed), d_in, d_h)
    p = GRU(d_in, d_h, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()}, strict=True)
    return jp, p


def test_gru_cell_matches_jax():
    """One step from a nonzero state; rtol 1e-5, atol 1e-6 (fp32)."""
    jp, p = _gru(12, 16, 0)
    r = np.random.RandomState(0)
    h = r.randn(4, 16).astype(np.float32)
    x = r.randn(4, 12).astype(np.float32)
    want, _ = jrnn.gru_cell(jp, jnp.asarray(h), jnp.asarray(x))
    got, again = gru_cell(p, torch.from_numpy(h), torch.from_numpy(x))
    assert got is again
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_run_gru_matches_jax(reverse):
    """d_h 16, S 9, both directions; the input's shares are one GEMM before
    the loop, a summation order the reference does not use: rtol 1e-5,
    atol 1e-6 (fp32)."""
    jp, p = _gru(12, 16, 1)
    xs = np.random.RandomState(1).randn(3, 9, 12).astype(np.float32)
    want = jrnn.run_gru(jp, jnp.asarray(xs), reverse=reverse)
    got = p(torch.from_numpy(xs), reverse=reverse)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_frontend_matches_jax_at_odd_sizes():
    """T 37 and F 30: both convolutions pad one more after than before on
    both axes (XLA's SAME). rtol 1e-4, atol 1e-5 on outputs of order 1
    (fp32 convolutions summed in another order, then normalized)."""
    cfg = dict(num_freq=30, conv_channels=4, d_h=8, num_gru=1)
    jmodel = jrnn.DS2(jrnn.DS2Config(**cfg))
    jparams = jmodel.init(jax.random.PRNGKey(2))
    model = DS2(DS2Config(**cfg), device="cpu")
    sd = ds2_params_from_jax(_np(jparams))
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith("gru.")}, strict=False)
    spec = np.random.RandomState(2).randn(2, 37, 30).astype(np.float32)
    want = np.asarray(jmodel._frontend(jparams, jnp.asarray(spec)))
    got = model.frontend(torch.from_numpy(spec)).detach().numpy()
    assert got.shape == want.shape == (2, same_out(same_out(37)),
                                       same_out(same_out(30)) * 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_ctc_loss_and_gradient_match_jax():
    """Repeated consecutive labels, label lengths below L (pads 0): loss
    rtol 1e-5, gradient atol 1e-6 (fp32 log-space sums)."""
    r = np.random.RandomState(3)
    logits = r.randn(3, 12, 5).astype(np.float32)
    labels = np.array([[1, 1, 2, 2], [3, 4, 0, 0], [2, 2, 2, 0]], np.int32)
    lens = np.array([4, 2, 3], np.int32)
    jloss, jgrad = jax.value_and_grad(jrnn.ctc_loss)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(lens))
    t_logits = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss(t_logits, torch.from_numpy(labels),
                    torch.from_numpy(lens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(jgrad),
                               atol=1e-6)


def test_ctc_matches_bruteforce():
    """``tests/test_system.py::test_ctc_matches_bruteforce``'s case: the
    sum over every alignment of length T collapsing to [1, 2]; rtol 1e-5."""
    T, V = 4, 3
    logits = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, T, V)))
    loss = ctc_loss(torch.from_numpy(logits), torch.tensor([[1, 2]]),
                    torch.tensor([2])).item()
    logp = np.asarray(jax.nn.log_softmax(logits[0], axis=-1))
    total = -np.inf
    for path in itertools.product(range(V), repeat=T):
        collapsed, prev = [], None
        for s in path:
            if s != prev and s != 0:
                collapsed.append(s)
            prev = s
        if collapsed == [1, 2]:
            total = np.logaddexp(total, sum(float(logp[t, s])
                                            for t, s in enumerate(path)))
    np.testing.assert_allclose(loss, -total, rtol=1e-5)


@pytest.mark.parametrize("sl", [64, 100])
def test_loss_and_every_gradient_match_jax(small_ds2, sl):
    """SMALL_DS2 (the JAX reproduction's DS2), batch 8. Loss rtol 1e-5;
    every gradient leaf max |port - jax| <= 1e-4 max |jax| (fp32: the
    convolutions and the GRU's GEMMs sum in another order)."""
    jmodel, jparams, model = small_ds2
    jbatch = jmodel.make_batch(sl, 8, sl)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)[0]))(jparams, jbatch)
    want = ds2_params_from_jax(_np(jgrads))
    names, params = zip(*model.named_parameters())
    loss, aux = model.loss(model.make_batch(sl, 8, sl))
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert aux["ctc"] is loss
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        ref = want[name].numpy()
        rel = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert rel <= 1e-4, (name, rel)


def test_make_batch_draws_the_jax_batch(small_ds2):
    jmodel, _, model = small_ds2
    jb, tb = jmodel.make_batch(7, 4, 200), model.make_batch(7, 4, 200)
    assert tb["labels"].dtype == tb["label_lens"].dtype == torch.long
    assert tb["labels"].shape == (4, 200 // 32)
    for k in ("spec", "labels", "label_lens"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_runs_at_161_bins_where_the_reference_does_not():
    """The reference sizes the first GRU as num_freq // 4 = 40 bins; its
    SAME convolutions leave ceil(ceil(161/2)/2) = 41, so its loss fails a
    shape check. The port sizes it from the convolutions."""
    cfg = dict(num_freq=161, conv_channels=2, d_h=8, num_gru=1)
    jmodel = jrnn.DS2(jrnn.DS2Config(**cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatch = jmodel.make_batch(0, 2, 64)
    with pytest.raises(TypeError, match="dot_general"):
        jax.eval_shape(lambda p, b: jmodel.loss(p, b)[0], jparams, jbatch)

    model = DS2(DS2Config(**cfg), device="cpu")
    assert model.gru[0].fwd.wx.shape == (41 * 2, 8)
    batch = model.make_batch(0, 2, 64)
    assert model.logits(batch["spec"]).shape == (2, 16, 29)
    assert math.isfinite(model.loss(batch)[0].item())


def test_machine_configs_scale_config1_as_the_reference():
    """Config #1 is the H100's fp32 peak and HBM rate; #2-#5 keep the
    reference's ratios to its own config #1 (to 1e-12)."""
    c1, j1 = machine.PAPER_CONFIGS["config1"], jmachine.PAPER_CONFIGS[
        "config1"]
    assert (c1.peak_flops, c1.hbm_bw) == (67e12, 3.35e12)
    assert set(machine.PAPER_CONFIGS) == set(jmachine.PAPER_CONFIGS)
    for name, m in machine.PAPER_CONFIGS.items():
        j = jmachine.PAPER_CONFIGS[name]
        assert m.name == j.name or name == "config1"
        for field in ("peak_flops", "hbm_bw"):
            assert math.isclose(getattr(m, field) / getattr(c1, field),
                                getattr(j, field) / getattr(j1, field),
                                rel_tol=1e-12), (name, field)
        # the execution models are the reference's arithmetic
        jm = jmachine.MachineConfig(m.name, m.peak_flops, m.hbm_bw,
                                    m.ici_bw, m.chips)
        for args in ((3e12, 2e9, 0.0), (1e9, 5e11, 1e6)):
            assert m.step_time(*args) == jm.step_time(*args)
            assert m.step_time_sum(*args) == jm.step_time_sum(*args)


def _lstm_flops(b, s, d_in, d_h):
    return s * 2 * b * (d_in + d_h) * 4 * d_h


def _gnmt_forward_flops(c, b, s):
    d, v = c.d_model, c.vocab_size
    return (2 * _lstm_flops(b, s, d, d // 2)
            + c.num_enc_uni * _lstm_flops(b, s, d, d)
            + _lstm_flops(b, s, 2 * d, d)
            + (c.num_dec - 1) * _lstm_flops(b, s, d, d)
            + 2 * b * s * d * d                    # q @ attn_q
            + 2 * 2 * b * s * s * d                # scores, context
            + 2 * b * s * 2 * d * d                # out_proj
            + 2 * b * s * d * v)                   # head


def _ds2_forward_flops(c, b, t):
    ch, h = c.conv_channels, c.d_h
    t1, f1 = same_out(t), same_out(c.num_freq)
    t2, f2 = same_out(t1), same_out(f1)
    flops = 2 * b * t1 * f1 * ch * 11 * 41                    # conv1
    flops += 2 * b * t2 * f2 * ch * ch * 11 * 21              # conv2
    for i in range(c.num_gru):
        d_in = f2 * ch if i == 0 else 2 * h
        # per direction: the input GEMM, then two GEMMs a step
        flops += 2 * (2 * b * t2 * d_in * 3 * h
                      + t2 * (2 * b * h * 2 * h + 2 * b * h * h))
    return flops + 2 * b * t2 * 2 * h * c.vocab_size           # head


@pytest.mark.parametrize("network,sl", [("gnmt", 8), ("gnmt", 13),
                                        ("ds2", 100), ("ds2", 256)])
def test_counted_forward_flops_equal_closed_form(network, sl):
    """Every timestep's matmuls are counted, exactly (integer counts)."""
    if network == "gnmt":
        cfg = SMALL_GNMT
        model = GNMT(cfg, device="cpu")
        batch, want = model.make_batch(0, 16, sl, sl), _gnmt_forward_flops(
            cfg, 16, sl)
        fn = lambda: model.loss(batch, use_kernel=False)  # noqa: E731
    else:
        cfg = SMALL_DS2
        model = DS2(cfg, device="cpu")
        batch, want = model.make_batch(0, 8, sl), _ds2_forward_flops(
            cfg, 8, sl)
        fn = lambda: model.loss(batch)  # noqa: E731
    flops, bts, hist = count_costs(fn)
    assert flops == want
    assert bts > 0 and sum(hist.values()) > 0


@pytest.mark.parametrize("network,sl", [("gnmt", 12), ("ds2", 192)])
def test_counted_step_flops_equal_flop_counter_mode(network, sl):
    """The counter reads FlopCounterMode's formulas itself; over a whole
    training step (forward, backward, update) the totals are equal."""
    setup = reproduction.SETUPS[network](CPU)
    fn, args = setup["count_builder"](sl)
    flops, _, _ = count_costs(fn, *args)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert flops == fc.get_total_flops() > 0


def test_views_count_no_bytes_and_the_histogram_keys():
    """Operand and result bytes of each op (a view operand at its own size),
    views none; keys are op and result shape."""
    x = torch.ones(4, 6)                               # 96 bytes

    def fn():
        z = x.t().contiguous()          # t: view; clone: 96 in, 96 out
        y = z @ torch.ones(4, 2)        # ones: 32 out; mm: 96 + 32, 48 out
        # slice: view; sum: 32 in, 4 out; add: 48 + 4 in, 48 out
        return y + x[:, :2].sum()

    flops, bts, hist = count_costs(fn)
    assert flops == 2 * 6 * 4 * 2
    assert bts == (96 + 96) + 32 + (96 + 32 + 48) + (32 + 4) + (48 + 4 + 48)
    assert hist["t:f32[6,4]"] == hist["slice:f32[4,2]"] == 1
    assert hist["mm:f32[6,2]"] == hist["sum:f32[]"] == 1


def test_reference_cost_analysis_counts_a_scan_body_once():
    """XLA's cost_analysis counts a lax.scan body once whatever its trip
    count, so the reference's Track A sees one timestep of each recurrent
    layer; the port's counter sees every step."""
    w = np.ones((256, 256), np.float32)
    step_flops = 2 * 16 * 256 * 256

    def jax_fn(w, xs):
        return jax.lax.scan(lambda h, x: (jnp.tanh(x @ w + h), None),
                            jnp.zeros((16, 256)), xs)[0]

    def port_fn(w, xs):
        h = torch.zeros(16, 256)
        for x in xs:
            h = torch.tanh(x @ w + h)
        return h

    for t in (1, 8, 64):
        xs = np.ones((t, 16, 256), np.float32)
        ca = jax.jit(jax_fn).lower(w, xs).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        assert step_flops <= ca["flops"] < 1.1 * step_flops, (t, ca["flops"])
        flops, _, _ = count_costs(port_fn, torch.from_numpy(w),
                                  torch.from_numpy(xs))
        assert flops == t * step_flops
