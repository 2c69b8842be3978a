"""The port's training path against the JAX package's on the CPU: run
configs, the LR schedule, AdamW, gradient compression, the resumable data
iterator, the train step and ten steps of the ``Trainer``, on the tiny
starcoder2-3b config of ``tests/test_resilience.py`` in float32, with the
JAX init's weights converted and numpy-seeded batches. Each test states its
tolerance."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import batching as jbatching
from repro.data import synthetic as jsynth
from repro.dist import compression as jcomp
from repro.dist.sharding import tp_activation_wire_bytes as jtp
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro.perfmodel.model_flops import param_count as jax_param_count
from repro.train import optimizer as jopt
from repro.train.train_step import build_train_step as jax_build_train_step
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.trainer import Trainer as JaxTrainer
import repro_torch.configs as tc
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data import batching as tbatching
from repro_torch.data import synthetic as tsynth
from repro_torch.dist import compression as tcomp
from repro_torch.dist.sharding import tp_activation_wire_bytes as ttp
from repro_torch.models.convert import (
    encdec_params_from_jax,
    transformer_params_from_jax,
)
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime
from repro_torch.perfmodel.model_flops import param_count
from repro_torch.resilience.recovery import RecoveryPolicy
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (
    assign_state,
    build_train_step,
    init_train_state,
    train_state_from_jax,
)
from repro_torch.train.trainer import Trainer

TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256)
# the tiny model in float32: sums taken in another order
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny model's ops are microseconds: threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(pkg, **kw):
    """The tiny run of ``tests/test_resilience.py`` from either package's
    configs; ``kw`` overrides RunConfig fields or, as ``opt``, the
    optimizer's."""
    opt = dict(lr=1e-3, warmup_steps=2, **kw.pop("opt", {}))
    cfg = pkg.smoke_config("starcoder2-3b").with_overrides(**TINY)
    return cfg, pkg.RunConfig(
        model=cfg, shape=pkg.ShapeConfig("tiny", seq_len=32, global_batch=8,
                                         step=pkg.StepKind.TRAIN),
        mesh=pkg.MeshConfig(shape=(1,), axes=("data",)),
        optimizer=pkg.OptimizerConfig(**opt), param_dtype="float32",
        compute_dtype="float32", **kw)


def _data(batching, synth, **kw):
    return batching.DataIterator(synth.IWSLT_LIKE, samples_per_epoch=256,
                                 batch_size=8, vocab_size=256, granularity=8,
                                 seed=1, **kw)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def jax_init():
    cfg, run = _run(jc)
    model = jax_build_model(cfg, JaxRuntime.from_run(run))
    params = model.init(jax.random.PRNGKey(run.seed))
    return model, run, jax.tree.map(np.asarray, params)


def _port_model(jax_init):
    cfg, run = _run(tc)
    model = build_model(cfg, Runtime.from_run(run), device="cpu")
    model.load_state_dict(transformer_params_from_jax(jax_init[2]),
                          strict=True)
    return model, run


# ---------------------------------------------------------------------------
# run configs and Runtime.from_run


@pytest.mark.parametrize("name", ["MeshConfig", "OptimizerConfig",
                                  "RunConfig"])
def test_run_configs_match_the_reference_field_by_field(name):
    mine, ref = getattr(tc, name), getattr(jc, name)
    assert [(f.name, str(f.default)) for f in dataclasses.fields(mine)] == \
        [(f.name, str(f.default)) for f in dataclasses.fields(ref)]
    for mesh in ("SINGLE_POD", "MULTI_POD"):
        a = getattr(tc.base, mesh)
        b = getattr(jc.base, mesh)
        assert (a.shape, a.axes, a.num_devices, a.data_degree,
                a.model_degree) == (b.shape, b.axes, b.num_devices,
                                    b.data_degree, b.model_degree)


def test_runtime_from_run_maps_dtypes_and_refuses_what_is_not_ported():
    """Nothing is refused any more: tensor parallelism, a fixed attention
    chunk and remat map as the reference maps them."""
    _, run = _run(tc)
    rt = Runtime.from_run(dataclasses.replace(
        run, param_dtype="bfloat16", compute_dtype="float32"))
    assert (rt.param_dtype, rt.compute_dtype) == (torch.bfloat16,
                                                  torch.float32)
    tp = tc.MeshConfig(shape=(2, 2), axes=("data", "model"))
    for knob, field, want in ((dict(mesh=tp), "tp_degree", 2),
                              (dict(attn_chunk=512), "attn_chunk", 512),
                              (dict(remat="block"), "remat", "block")):
        got = Runtime.from_run(dataclasses.replace(run, **knob))
        assert getattr(got, field) == want
    # a model axis under dp_only parallelism is data parallelism
    assert Runtime.from_run(dataclasses.replace(
        run, mesh=tp, parallelism="dp_only")).tp_degree == 1


@pytest.mark.parametrize("arch", jc.list_archs())
def test_param_count_matches_the_reference(arch):
    """The example's non-embedding parameter count, every arch, both
    modes, exactly."""
    for active in (False, True):
        assert param_count(tc.get_model_config(arch), active) == \
            jax_param_count(jc.get_model_config(arch), active)


# ---------------------------------------------------------------------------
# the data iterator: pure numpy, so equal, not close


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bucketed=True),
    dict(sort_first_epoch=True),
    dict(shard_id=1, num_shards=2),
])
def test_data_iterator_is_the_reference_exactly(kw):
    mine = _data(tbatching, tsynth, **kw)
    ref = _data(jbatching, jsynth, **kw)
    a, b = iter(mine), iter(ref)
    for i in range(40):                         # 32 batches an epoch
        if i == 23:                             # resume mid-epoch from state
            state = mine.state()
            assert state == ref.state()
            mine.restore(dict(state))
            a = iter(mine)
        (ta, la, sa), (tb, lb, sb) = next(a), next(b)
        assert sa == sb
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)
        assert mine.state() == ref.state()
    assert mine.state()["epoch"] == 1


def test_data_iterator_lm_documents_is_the_reference_exactly():
    mine = tbatching.DataIterator(tsynth.lm_documents(256),
                                  samples_per_epoch=4096, batch_size=8,
                                  vocab_size=49152, granularity=16, seed=0)
    ref = jbatching.DataIterator(jsynth.lm_documents(256),
                                 samples_per_epoch=4096, batch_size=8,
                                 vocab_size=49152, granularity=16, seed=0)
    for (ta, la, sa), (tb, lb, sb), _ in zip(mine, ref, range(40)):
        assert sa == sb
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)


# ---------------------------------------------------------------------------
# the LR schedule and AdamW


@pytest.mark.parametrize("warmup,total", [(0, 50), (2, 40), (10, 1000),
                                          (100, 40)])
def test_lr_schedule_matches_the_reference(warmup, total):
    """Within 1e-6 relative (the reference computes in float32): 0 at step
    0, the warmup ramp, the cosine and the floor past the end."""
    mine = topt.lr_schedule(tc.OptimizerConfig(lr=3e-4, warmup_steps=warmup),
                            total)
    ref = jopt.lr_schedule(jc.OptimizerConfig(lr=3e-4, warmup_steps=warmup),
                           total)
    steps = list(range(0, total + 20))
    got = np.array([mine(s) for s in steps])
    want = np.array([float(ref(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0


# decayable and non-decayable last keys, as the reference's mask reads them
_KEYS = ["embed", "final_norm", "lm_head", "layers.0.mixer_norm",
         "layers.0.mixer.wq", "layers.0.ffn.wi", "layers.1.mixer.dt_bias",
         "layers.1.mixer.mu_x", "layers.1.mixer.w0", "layers.1.ffn.b_up"]


def _nest(flat):
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}} for the JAX tree."""
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _unnest(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_unnest(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 20])
def test_adamw_update_matches_the_reference(moment_dtype, steps):
    """Random float32 params and gradients (a new draw each step, large
    enough that clipping engages). float32: params, m and v within 1e-6
    relative of max |.| (sums and sqrt in another order). bfloat16 moments:
    the arithmetic is bf16, so within two bf16 steps (2**-7) relative of
    max |.|."""
    r = np.random.RandomState(steps)
    shapes = {k: (6, 5) if i % 2 else (7,) for i, k in enumerate(_KEYS)}
    p0 = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=0, moment_dtype=moment_dtype)
    mcfg, rcfg = tc.OptimizerConfig(**kw), jc.OptimizerConfig(**kw)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    jparams = _nest({k: jnp.asarray(v) for k, v in p0.items()})
    state, jstate = topt.init_opt_state(params, mcfg), \
        jopt.init_opt_state(jparams, rcfg)
    for _ in range(steps):
        g = {k: (3 * r.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
        metrics = topt.adamw_update({k: torch.tensor(v) for k, v in g.items()},
                                    state, params, mcfg, 1e-2)
        jparams, jstate, jm = jopt.adamw_update(
            _nest({k: jnp.asarray(v) for k, v in g.items()}), jstate,
            jparams, rcfg, jnp.float32(1e-2))
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert state.step == int(jstate.step) == steps
    rel = 1e-6 if moment_dtype == "float32" else 2 ** -7
    for mine, ref in ((params, jparams), (state.m, jstate.m),
                      (state.v, jstate.v)):
        ref = _unnest(ref)
        assert sorted(mine) == sorted(ref)
        for k in mine:
            want = np.asarray(ref[k], np.float32)
            assert mine[k].dtype == getattr(torch, str(ref[k].dtype))
            np.testing.assert_allclose(_np(mine[k]), want, rtol=0,
                                       atol=rel * np.abs(want).max(),
                                       err_msg=k)


def test_decay_mask_matches_the_reference_leaf_by_leaf(jax_init):
    """The port's parameter names end in the reference's leaf keys."""
    jparams = jax_init[2]
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [str(k.key) if hasattr(k, "key") else str(k.idx)
                for k in path]
        want[tuple(keys)] = jopt._decayable(path)
    model, _ = _port_model(jax_init)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 3 + 8 * TINY["num_layers"]
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            parts = ["layers", "0"] + parts[2:]
        assert topt._decayable(name) == want[tuple(parts)], name
    assert not topt._decayable("layers.1.mixer_norm")
    assert topt._decayable("layers.1.ffn.wo")


def test_adamw_optimizes_quadratic():
    """The reference's own test (``tests/test_system.py``) on the port."""
    cfg = tc.OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                             grad_clip=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = topt.init_opt_state(params, cfg)
    lr_fn = topt.lr_schedule(cfg, 200)
    for _ in range(150):
        topt.adamw_update({"x": 2 * params["x"]}, state, params, cfg,
                          lr_fn(state.step))
    assert float(params["x"].abs().max()) < 0.1


# ---------------------------------------------------------------------------
# gradient compression, on the model's own gradient tree


@pytest.fixture(scope="module")
def grad_tree(jax_init):
    """The JAX model's gradient at its init on one batch, plus 1e-6 of
    numpy noise so that no two magnitudes tie (an embedding row no token
    uses has exact zeros, and ``torch.topk`` and ``lax.top_k`` may order
    ties differently)."""
    model, _, params = jax_init
    toks, labels, _ = next(iter(_data(jbatching, jsynth)))
    grads = jax.grad(lambda p: model.loss(p, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})[0])(
            jax.tree.map(jnp.asarray, params))
    r = np.random.RandomState(0)
    grads = jax.tree.map(
        lambda g: (np.asarray(g) + 1e-6 * r.randn(*g.shape)).astype(
            np.float32), grads)
    return grads


@pytest.fixture(scope="module")
def whisper_grad_tree():
    """whisper-medium's smoke-size gradient at the JAX init on one
    numpy-seeded batch (64 frames, 32 tokens): two 2-layer stacks,
    ``enc_layers`` and ``dec_layers``. With 1e-6 of numpy noise, as the
    tiny model's tree; but its magnitudes tie in float32 (most rows of
    ``dec_pos`` have no gradient, and the tied head gives ``embed`` equal
    entries), and top-k orders ties by package, so each later copy of a
    magnitude moves one float32 step away from zero until none ties."""
    jcfg = jc.smoke_config("whisper-medium")
    model = jax_build_model(jcfg, JaxRuntime())
    params = model.init(jax.random.PRNGKey(0))
    r = np.random.RandomState(0)
    batch = {"frames": r.randn(4, jcfg.encoder.max_source_len,
                               jcfg.d_model).astype(np.float32),
             "tokens": r.randint(0, 512, (4, 32)).astype(np.int32),
             "labels": r.randint(0, 512, (4, 32)).astype(np.int32)}
    grads = jax.grad(lambda p: model.loss(p, jax.tree.map(
        jnp.asarray, batch))[0])(params)

    def untied(g):
        a = (np.asarray(g) + 1e-6 * r.randn(*g.shape)).astype(
            np.float32).reshape(-1)
        while True:
            _, first = np.unique(np.abs(a), return_index=True)
            if first.size == a.size:
                return a.reshape(g.shape)
            later = np.ones(a.size, bool)
            later[first] = False
            a[later] = np.nextafter(a[later], np.where(
                a[later] < 0, -np.inf, np.inf).astype(np.float32))

    return jax.tree.map(untied, grads)


def _flat_paths(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                       for k in path)
        out[key] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("arch,method", [
    *(pytest.param("starcoder2-3b", m, id=m)
      for m in ("none", "bf16", "int8_ef", "topk_ef")),
    *(pytest.param("whisper-medium", m, id=f"whisper-medium-{m}")
      for m in ("int8_ef", "topk_ef"))])
def test_compression_wire_and_residual_match_the_reference(request, arch,
                                                           method):
    """Two layers stacked on the reference's leading axis (whisper: its
    ``enc_layers`` and ``dec_layers`` stacks): the wire (int8 scale and
    codes, top-k indices and values, bf16 codes) and the residual are
    equal to the reference's; the dense gradient rebuilt from the wire
    within 1e-7 of max |g| (float32 products in another order)."""
    if arch == "whisper-medium":
        grad_tree = request.getfixturevalue("whisper_grad_tree")
        convert = encdec_params_from_jax
    else:
        grad_tree = request.getfixturevalue("grad_tree")
        convert = transformer_params_from_jax
    grads = {k: torch.from_numpy(np.array(v)) for k, v in
             convert(grad_tree).items()}
    wire, err = tcomp.compress_grads(grads, method, period=1)
    jwire, jerr = jcomp.compress_grads(
        jax.tree.map(jnp.asarray, grad_tree), method)
    assert sorted(wire) == sorted(jwire)
    for part in wire:
        want = _flat_paths(jwire[part])
        if method == "none":
            want = {k: torch.from_numpy(np.array(v)) for k, v in
                    transformer_params_from_jax(
                        jax.tree.map(np.asarray, jwire[part])).items()}
        assert sorted(wire[part]) == sorted(want), part
        for key, t in wire[part].items():
            np.testing.assert_array_equal(
                t.float().numpy() if t.dtype == torch.bfloat16 else
                t.numpy(), np.asarray(want[key], np.float32)
                if t.dtype == torch.bfloat16 else np.asarray(want[key]),
                err_msg=f"{part}/{key}")
    if method == "none":
        assert err is None and jerr is None
    else:
        jerr = convert(jax.tree.map(np.asarray, jerr))
        assert sorted(err) == sorted(jerr)
        for k in err:
            np.testing.assert_array_equal(err[k].numpy(), jerr[k].numpy(),
                                          err_msg=k)
    dense = tcomp.decompress_grads(wire, method, grads, period=1)
    jdense = convert(jax.tree.map(
        np.asarray, jcomp.decompress_grads(
            jwire, method, jax.tree.map(jnp.asarray, grad_tree))))
    for k, t in dense.items():
        assert t.dtype == grads[k].dtype
        want = jdense[k].numpy()
        np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                   atol=1e-7 * np.abs(want).max() + 1e-30)


def test_compression_stacks_layers_as_the_reference_does(grad_tree):
    """The int8 scale of ``layers/0/mixer/wq`` is the absmax over both
    layers: one tensor a layer would give layer 1 a scale of its own."""
    grads = {k: torch.from_numpy(np.array(v)) for k, v in
             transformer_params_from_jax(grad_tree).items()}
    wire, _ = tcomp.compress_grads(grads, "int8_ef", period=1)
    both = max(float(grads[f"layers.{i}.mixer.wq"].abs().max())
               for i in range(2))
    assert float(wire["scale"]["layers/0/mixer/wq"]) == \
        pytest.approx(both / 127.0, rel=1e-7)
    per_layer = [float(grads[f"layers.{i}.mixer.wq"].abs().max()) / 127.0
                 for i in range(2)]
    assert per_layer[0] != per_layer[1]
    assert tcomp.leaf_groups(["layers.0.a", "layers.3.a", "layers.1.a",
                              "layers.2.a", "embed"], period=2) == {
        "layers/0/a": ["layers.0.a", "layers.2.a"],
        "layers/1/a": ["layers.1.a", "layers.3.a"], "embed": ["embed"]}


@pytest.mark.parametrize("method", ["int8_ef", "topk_ef"])
def test_compression_stacks_whisper_layers_as_the_reference_does(
        whisper_grad_tree, method):
    """whisper's ``enc_layers.N`` and ``dec_layers.N`` go on wire as the
    reference's two stacks, 37 leaves for its 67 tensors: the int8 scale
    of ``enc_layers/attn/wk`` is the absmax over both encoder layers, and
    top-k keeps 5 % of the whole stack, not 5 % of each layer."""
    grads = {k: torch.from_numpy(np.array(v)) for k, v in
             encdec_params_from_jax(whisper_grad_tree).items()}
    wire, _ = tcomp.compress_grads(grads, method, period=1)
    jwire, _ = jcomp.compress_grads(
        jax.tree.map(jnp.asarray, whisper_grad_tree), method)
    part = "scale" if method == "int8_ef" else "idx"
    assert len(grads) == 67
    assert sorted(wire[part]) == sorted(_flat_paths(jwire[part]))
    assert len(wire[part]) == 37
    layers = [grads[f"enc_layers.{i}.attn.wk"] for i in range(2)]
    if method == "int8_ef":
        both = max(float(g.abs().max()) for g in layers)
        assert float(wire["scale"]["enc_layers/attn/wk"]) == \
            pytest.approx(both / 127.0, rel=1e-7)
        assert float(layers[0].abs().max()) != float(layers[1].abs().max())
    else:
        n = sum(g.numel() for g in layers)
        assert wire["idx"]["enc_layers/attn/wk"].numel() == \
            tcomp._topk_k(n) == math.ceil(tcomp.TOPK_FRACTION * n)
    assert tcomp.leaf_groups(["dec_layers.1.ffn.bi", "enc_layers.0.ffn.bi",
                              "dec_layers.0.ffn.bi", "embed"], period=1) == {
        "dec_layers/ffn/bi": ["dec_layers.0.ffn.bi", "dec_layers.1.ffn.bi"],
        "enc_layers/ffn/bi": ["enc_layers.0.ffn.bi"], "embed": ["embed"]}


def test_int8_error_feedback_bound():
    """The reference's own test (``tests/test_system.py``) on the port."""
    g = {"w": torch.from_numpy(np.random.RandomState(1).randn(64, 64)
                               .astype(np.float32))}
    wire, err = tcomp.compress_grads(g, "int8_ef")
    out = tcomp.decompress_grads(wire, "int8_ef", g)
    assert float((out["w"] - g["w"]).norm() / g["w"].norm()) < 0.02
    np.testing.assert_allclose((out["w"] + err["w"]).numpy(), g["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["none", "bf16", "int8_ef", "topk_ef"])
def test_wire_accounting_matches_the_reference(jax_init, method):
    model, _ = _port_model(jax_init)
    params = dict(model.named_parameters())
    for dp in (1, 2, 8):
        for gb in (2.0, 4.0):
            assert tcomp.dp_grad_wire_bytes(
                params, method, dp, grad_dtype_bytes=gb, micro_reduces=2) \
                == jcomp.dp_grad_wire_bytes(
                    jax_init[2], method, dp, grad_dtype_bytes=gb,
                    micro_reduces=2)
    assert tcomp.wire_bytes_per_elem(method, 2.0) == \
        jcomp.wire_bytes_per_elem(method, 2.0)
    zeros = tcomp.init_residual(params, method)
    assert (zeros is None) == (jcomp.init_residual(jax_init[2], method)
                               is None)
    cfg = tc.get_model_config("starcoder2-3b")
    for tp in (1, 2, 16):
        assert ttp(cfg, 8, 256, tp) == jtp(
            jc.get_model_config("starcoder2-3b"), 8, 256, tp)


@pytest.mark.parametrize("method", ["none", "bf16", "int8_ef", "topk_ef"])
def test_wire_accounting_matches_the_reference_on_whisper(method):
    """whisper-medium at smoke size, the port's model against the
    reference's init: the same DP wire bytes and residual structure."""
    jmodel = jax_build_model(jc.smoke_config("whisper-medium"), JaxRuntime())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = dict(build_model(tc.smoke_config("whisper-medium"),
                              device="cpu").named_parameters())
    for dp in (1, 2, 8):
        for gb in (2.0, 4.0):
            assert tcomp.dp_grad_wire_bytes(
                params, method, dp, grad_dtype_bytes=gb, micro_reduces=2) \
                == jcomp.dp_grad_wire_bytes(
                    jparams, method, dp, grad_dtype_bytes=gb,
                    micro_reduces=2)
    zeros = tcomp.init_residual(params, method)
    jzeros = jcomp.init_residual(jparams, method)
    assert (zeros is None) == (jzeros is None)
    if zeros is not None:
        want = encdec_params_from_jax(jax.tree.map(np.asarray, jzeros))
        assert {k: tuple(v.shape) for k, v in zeros.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the train step


def _batches(n):
    """``n`` batches of the tiny run's iterator, all padded to one SL so
    the JAX step compiles once."""
    it = iter(_data(jbatching, jsynth))
    out = []
    for _ in range(n):
        toks, labels, _ = next(it)
        t = np.zeros((8, 32), np.int32)
        lab = np.full((8, 32), -1, np.int32)
        w = min(toks.shape[1], 32)
        t[:, :w], lab[:, :w] = toks[:, :w], labels[:, :w]
        out.append((t, lab))
    return out


def _torch_batch(t, lab):
    return {"tokens": torch.as_tensor(t, dtype=torch.long),
            "labels": torch.as_tensor(lab, dtype=torch.long)}


def _jax_steps(jax_init, run_kw, batches, state=None):
    model, _, params = jax_init
    _, run = _run(jc, **run_kw)
    step = jax.jit(jax_build_train_step(model, run, total_steps=40))
    if state is None:
        state = jax_init_train_state(model, run, jax.random.PRNGKey(0))
        state = state._replace(params=jax.tree.map(jnp.asarray, params))
    out = []
    for t, lab in batches:
        state, m = step(state, {"tokens": jnp.asarray(t),
                                "labels": jnp.asarray(lab)})
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _assert_state_close(mine, ref, bound, lr_steps, flips=0.0):
    """Params within ``bound`` x lr x (steps with lr > 0) absolute: Adam's
    normalized step m_hat / sqrt(v_hat) turns float noise in a near-zero
    gradient entry into a step of up to lr, so an entry's difference is
    bounded by lr per step, not by the gradient's precision. Moments within
    1e-4 of max |.| (float32 gradients summed in another order). The int8
    residual within 1e-2 of max |.|: it is at most half an int8 step,
    max |g| / 254, so the gradients' float noise weighs ~250x more in it,
    and grows as the parameters part. Under int8_ef a share ``flips`` of
    entries may miss these: a code that rounds the other way at a
    float-noise tie moves its entry's gradient by a whole int8 step, and
    the moments and the residual with it."""
    ref = train_state_from_jax(jax.tree.map(np.asarray, ref))
    assert mine.opt.step == ref.opt.step
    for name, p in mine.params.items():
        np.testing.assert_allclose(_np(p), ref.params[name].numpy(), rtol=0,
                                   atol=bound * lr_steps, err_msg=name)
    assert (mine.ef is None) == (ref.ef is None)
    pairs = [(mine.opt.m, ref.opt.m, 1e-4), (mine.opt.v, ref.opt.v, 1e-4)]
    if mine.ef is not None:
        pairs.append((mine.ef, ref.ef, 1e-2))
    for a, b, rel in pairs:
        for name in a:
            want = b[name].numpy()
            off = np.abs(_np(a[name]) - want) > rel * np.abs(want).max()
            assert off.mean() <= flips, (name, int(off.sum()), off.size)


@pytest.mark.parametrize("run_kw", [
    dict(), dict(microbatches=2), dict(opt=dict(grad_compression="int8_ef")),
], ids=["plain", "microbatches2", "int8_ef"])
def test_train_step_matches_the_reference(jax_init, run_kw):
    """Four steps from the converted init (the first at lr 0 moves only the
    moments): loss and grad norm within 1e-5 relative, the state as
    ``_assert_state_close`` bounds it (lr 1e-3 at warmup 2: lr x steps with
    lr > 0 is 2.5e-3)."""
    batches = _batches(4)
    jstate, jmetrics = _jax_steps(jax_init, dict(run_kw), batches)
    model, _ = _port_model(jax_init)
    _, run = _run(tc, **dict(run_kw))
    step = build_train_step(model, run, total_steps=40)
    state = init_train_state(model, run)
    for (t, lab), jm in zip(batches, jmetrics):
        state, m = step(state, _torch_batch(t, lab))
        for k in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5,
                                       err_msg=k)
    if "microbatches" in run_kw:
        assert all(a.dtype == torch.float32 for a in state.opt.m.values())
    assert (state.ef is not None) == ("opt" in run_kw)
    _assert_state_close(state, jstate, 0.02, 2.5e-3,
                        flips=1e-3 if "opt" in run_kw else 0.0)


# ---------------------------------------------------------------------------
# ten Trainer steps against the JAX Trainer, and resuming its checkpoint


@pytest.fixture(scope="module")
def jax_trained(jax_init, tmp_path_factory):
    """The JAX Trainer's 10 steps with a checkpoint every 5."""
    model, run, _ = jax_init
    ck = str(tmp_path_factory.mktemp("jax_ck"))
    tr = JaxTrainer(model, run, _data(jbatching, jsynth), ckpt_dir=ck,
                    ckpt_every=5, total_steps=40)
    rep = tr.train(10)
    like = jax_init_train_state(model, run, jax.random.PRNGKey(0))
    mgr = JaxCheckpointManager(ck)
    final, _ = mgr.restore(like, step=10)
    mid, extra = mgr.restore(like, step=5)
    return rep, tr.epoch_log, final, (mid, extra)


def test_ten_trainer_steps_match_the_jax_trainer(jax_init, jax_trained,
                                                 tmp_path):
    """Losses within rtol 1e-4, identical SLs; the final parameters within
    0.02 x lr x steps (see ``_assert_state_close``; lr 1e-3 with a 2-step
    warmup and a 40-step cosine: the sum of lr over the 10 steps is
    8.6e-3)."""
    rep, jlog, jfinal, _ = jax_trained
    model, run = _port_model(jax_init)
    tr = Trainer(model, run, _data(tbatching, tsynth), ckpt_dir=str(tmp_path),
                 ckpt_every=5, total_steps=40)
    mine = tr.train(10)
    np.testing.assert_allclose(mine.losses, rep.losses, rtol=LOSS_RTOL)
    assert [it.seq_len for it in tr.epoch_log.iterations] == \
        [it.seq_len for it in jlog.iterations]
    assert tr.epoch_log.num_iterations == 10
    _assert_state_close(_state_of(tr, model, run), jfinal, 0.02, 8.6e-3)


def _state_of(tr, model, run):
    """The trainer's final state, read back from its final checkpoint."""
    state = init_train_state(model, run)
    restored, extra = tr.ckpt.restore(state)
    assert extra["step"] == 10
    return restored


def test_a_jax_run_resumes_in_the_port(jax_init, jax_trained, tmp_path):
    """The JAX run's step-5 checkpoint, converted by
    ``train_state_from_jax`` and given the same ``extra`` (iterator
    position, partial EpochLog), resumes in the port's Trainer: steps 5-9
    give the JAX run's losses (rtol 1e-4) and SLs, and the final state is
    bounded as in the ten-step test."""
    rep, jlog, jfinal, (mid, extra) = jax_trained
    model, run = _port_model(jax_init)
    state = init_train_state(model, run)
    assign_state(state, train_state_from_jax(jax.tree.map(np.asarray, mid)))
    assert state.opt.step == 5
    CheckpointManager(str(tmp_path)).save(5, state, extra=extra)
    model2, _ = _port_model(jax_init)            # the init, overwritten
    tr = Trainer(model2, run, _data(tbatching, tsynth),
                 ckpt_dir=str(tmp_path), ckpt_every=5, total_steps=40,
                 policy=RecoveryPolicy(backoff_base_s=0.0))
    mine = tr.train(5)
    assert mine.resumed_from == 5
    np.testing.assert_allclose(mine.losses, rep.losses[5:], rtol=LOSS_RTOL)
    assert [it.seq_len for it in tr.epoch_log.iterations] == \
        [it.seq_len for it in jlog.iterations]
    _assert_state_close(_state_of(tr, model2, run), jfinal, 0.02, 8.6e-3)
