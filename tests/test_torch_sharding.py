"""The port's sharding rules against the JAX package's, with no process
group: for every arch of ``list_archs()`` at full width, ``param_specs``
on the port's model built on the ``meta`` device equals the reference's
``param_specs`` on ``jax.eval_shape`` of its init, tensor by tensor through
the converter's name map with the stacking dim dropped, on ``SINGLE_POD``,
``MULTI_POD`` and a (2, 4) mesh, with FSDP off and on (and over pods),
``moe_full_ep`` and ``parallelism="dp_only"``. ``batch_specs``,
``cache_specs`` and ``dp_grad_reduce_elems`` are held to the reference the
same way, and ``dist/axes`` as ``tests/test_dist.py`` holds the
reference's: ``_resolve``, ``set_dp_axes`` scoping, ``constrain`` as the
identity without a mesh and its checks under a one-rank mesh."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jc
from repro.dist import sharding as jsh
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro_torch import configs as tc
from repro_torch.dist import axes as taxes
from repro_torch.dist import sharding as tsh
from repro_torch.models.convert import _flatten
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
OPTIONS = [dict(), dict(fsdp=True), dict(fsdp=True, fsdp_over_pods=True),
           dict(moe_full_ep=True), dict(moe_full_ep=True, fsdp=True),
           dict(parallelism="dp_only"), dict(parallelism="dp_only",
                                             fsdp=True)]
_STACKS = ("layers", "enc_layers", "dec_layers")


@functools.lru_cache(maxsize=None)
def _models(arch, tp):
    """The reference's parameter shapes and the port's meta model, both at
    the production bf16 parameter type and padded for ``tp``."""
    jcfg = jc.get_model_config(arch)
    jmodel = jax_build_model(jcfg, JaxRuntime(tp_degree=tp,
                                              param_dtype=jnp.bfloat16))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = build_model(tc.get_model_config(arch),
                         Runtime(tp_degree=tp, param_dtype=torch.bfloat16),
                         device="meta")
    return jcfg, jmodel, shapes, tmodel


def _by_port_name(tree, cfg):
    """A reference tree (specs or shapes) -> {port name: (leaf, stacked)},
    the stacks split as ``models/convert.py`` splits them."""
    out = {k: (v, False) for k, v in _flatten(
        {k: v for k, v in tree.items() if k not in _STACKS}, "").items()}
    if "layers" in tree:
        period = len(tree["layers"])
        n = cfg.num_layers // period
        for j, entry in enumerate(tree["layers"]):
            for path, leaf in _flatten(entry, "").items():
                for i in range(n):
                    out[f"layers.{i * period + j}.{path}"] = (leaf, True)
    for name, n in (("enc_layers", cfg.encoder and cfg.encoder.num_layers),
                    ("dec_layers", cfg.num_layers)):
        if name in tree:
            for path, leaf in _flatten(tree[name], "").items():
                for i in range(n):
                    out[f"{name}.{i}.{path}"] = (leaf, True)
    return out


def _mesh(key):
    shape, axes = MESHES[key]
    return (tc.MeshConfig(shape=shape, axes=axes),
            jc.MeshConfig(shape=shape, axes=axes))


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", jc.list_archs())
def test_param_specs_match_the_reference(arch, mesh_key):
    tmesh, jmesh = _mesh(mesh_key)
    jcfg, _, shapes, tmodel = _models(arch, jmesh.model_degree)
    tcfg = tc.get_model_config(arch)
    for opts in OPTIONS:
        want = _by_port_name(jsh.param_specs(shapes, jcfg, jmesh, **opts),
                             jcfg)
        got = tsh.param_specs(tmodel, tcfg, tmesh, **opts)
        assert set(got) == set(want), opts
        for name, (spec, stacked) in want.items():
            spec = tuple(spec)
            if stacked:
                assert spec[0] is None, (opts, name)
                spec = spec[1:]
            assert got[name] == spec, (opts, name, got[name], spec)
        # the per-device DP reduction sums the same elements
        jspecs = jsh.param_specs(shapes, jcfg, jmesh, **opts)
        assert tsh.dp_grad_reduce_elems(tmodel, got, tmesh) == \
            pytest.approx(jsh.dp_grad_reduce_elems(shapes, jspecs, jmesh),
                          rel=1e-12)


def test_param_specs_shard_where_the_reference_docs_say():
    tmesh, _ = _mesh("single")
    _, _, _, tmodel = _models("mistral-nemo-12b", 16)
    specs = tsh.param_specs(tmodel, tc.get_model_config("mistral-nemo-12b"),
                            tmesh)
    assert specs["embed"] == ("model", None)
    assert specs["lm_head"] == (None, "model")
    assert specs["layers.0.mixer.wq"] == (None, "model")
    assert specs["layers.0.mixer.wo"] == ("model", None)
    assert specs["layers.0.mixer.wk"] == (None, None)   # 8 kv heads, tp 16
    big = tsh.param_specs(tmodel, tc.get_model_config("mistral-nemo-12b"),
                          tmesh, fsdp=True)
    assert "data" in big["layers.0.ffn.wi"]


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", jc.list_archs())
def test_batch_and_cache_specs_match_the_reference(arch, mesh_key):
    tmesh, jmesh = _mesh(mesh_key)
    jcfg, jmodel, _, tmodel = _models(arch, jmesh.model_degree)
    tcfg = tc.get_model_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        jshape, tshape = jc.get_shape(name), tc.get_shape(name)
        inputs = jmodel.input_specs(jshape)
        tinputs = {k: torch.empty(v.shape, device="meta")
                   for k, v in inputs.items()}
        for par in ("tp", "dp_only"):
            want = jsh.batch_specs(inputs, jmesh, jshape, parallelism=par)
            got = tsh.batch_specs(tinputs, tmesh, tshape, parallelism=par)
            assert got == {k: tuple(v) for k, v in want.items()}
    shape = jc.get_shape("decode_32k")
    b, s = shape.global_batch, 64
    want = jsh.cache_specs(jax.eval_shape(lambda: jmodel.init_cache(b, s)),
                           jcfg, jmesh, shape)
    got = tsh.cache_specs(tmodel.init_cache(b, s), tcfg, tmesh,
                          tc.get_shape("decode_32k"))
    pairs = []
    if jcfg.encoder is not None:
        for part in ("self", "cross"):
            for layer in got[part]:
                pairs += list(zip(layer, want[part]))
    else:
        period = len(want)
        for i, layer in enumerate(got):
            ref = want[i % period]
            if isinstance(layer, tuple):
                pairs += list(zip(layer, ref["mixer"]))
            else:
                for part, leaves in layer.items():
                    pairs += [(leaves[k], ref[part][k]) for k in leaves]
    assert pairs
    for mine, ref in pairs:
        ref = tuple(ref)
        assert ref[0] is None
        assert mine == ref[1:]


# ---------------------------------------------------------------------------
# dist/axes


def test_resolve_defaults():
    mesh_axes = ("pod", "data", "model")
    assert taxes._resolve("dp", mesh_axes) == ("pod", "data")
    assert taxes._resolve("tp", mesh_axes) == ("model",)
    assert taxes._resolve("ep", mesh_axes) == ("data", "model")
    assert taxes._resolve(None, mesh_axes) == ()
    assert taxes._resolve("data", mesh_axes) == ("data",)
    assert taxes._resolve("nonexistent", mesh_axes) == ()
    assert taxes._resolve("dp", ("data", "model")) == ("data",)


def test_set_dp_axes_scoping_restores():
    assert taxes.dp_axes() == ("pod", "data")
    with taxes.set_dp_axes(("pod", "data", "model")):
        assert taxes._resolve("dp", ("pod", "data", "model")) == \
            ("pod", "data", "model")
        with taxes.set_dp_axes(("data",)):
            assert taxes.dp_axes() == ("data",)
        assert taxes.dp_axes() == ("pod", "data", "model")
    assert taxes.dp_axes() == ("pod", "data")
    taxes.set_dp_axes(("data",))
    assert taxes.dp_axes() == ("data",)
    taxes.set_dp_axes(None)
    assert taxes.dp_axes() == ("pod", "data")


def test_constrain_no_mesh_is_identity():
    assert taxes.current_mesh_axes() == ()
    assert taxes.active_mesh() is None
    x = torch.ones(4, 8)
    assert taxes.constrain(x, "dp", "tp") is x
    assert taxes.constrain(x, "dp") is x


def test_constrain_and_placements_under_a_one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        assert taxes.placements((None, "model"), mesh) == \
            [Replicate(), Shard(1)]
        assert taxes.placements((("data", "model"), None), mesh) == \
            [Shard(0), Shard(0)]
        x = distribute_tensor(torch.ones(4, 8), mesh,
                              [Replicate(), Replicate()])
        with taxes.use_mesh(mesh):
            assert taxes.current_mesh_axes() == ("data", "model")
            with pytest.raises(ValueError):
                taxes.constrain(x, "dp")             # rank mismatch
            # extent-1 axes leave the tensor as it is
            assert taxes.constrain(x, "dp", "tp") is x
            plain = torch.ones(4, 8)
            assert taxes.constrain(plain, "dp", "tp") is plain
        assert taxes.active_mesh() is None
    finally:
        dist.destroy_process_group()
