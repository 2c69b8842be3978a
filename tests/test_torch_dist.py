"""Sharded execution of the port against the JAX package's, the port's
counterpart of ``tests/test_dist_exec.py``.

Six cases at ``smoke_config`` with ``vocab_size=512``, batch 4 x 32 and
``Runtime(tp_degree=4)`` (padded heads included): qwen2-moe-a2.7b (the
expert-parallel MoE), mistral-nemo-12b (dense GQA), jamba-v0.1-52b (mamba,
attention and MoE), rwkv6-3b (padded heads), qwen2-moe-a2.7b with
``moe_full_ep`` (the all-to-all path) and qwen2-moe-a2.7b with FSDP at
``FSDP_MIN_BYTES = 0`` in both packages, so that every layer leaf really
executes sharded over "data".

One JAX subprocess (8 host devices) computes each case's loss and
gradients on its 2 x 4 ("data", "model") mesh with the production rules
and writes the parameters, the batch and the results as ``.npz``. Then
this file, run as a script, is launched as 8 ``gloo`` ranks (one thread
each, a ``FileStore`` under the test's temporary directory): each loads
the converted weights, distributes them as DTensors by the port's
``param_specs`` on a 2 x 4 ``DeviceMesh`` and computes the same loss and
every gradient (``embed``'s and one expert's, or a mixer kernel's, among
them, checked to be nonzero).

Tolerances, float32 on both sides: loss rtol 1e-4; each gradient within
1e-3 of its largest |value| (sums taken in another order and over other
shards).

Decode under the mesh, in the same two runs: starcoder2-3b (GQA with its
two KV heads replicated over "model"), rwkv6-3b (padded heads; the WKV
state) and deepseek-v3-671b (MLA's latent cache, the MoE), each one decode
step at ``cache_index`` 5 from a cache of 16 positions filled from a seeded
``RandomState`` and placed by ``cache_specs`` in both packages, against
the JAX 8-device ``decode_step``: the logits and every updated cache leaf
within 1e-4 of the leaf's largest |value|.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORLD = 8
MESH = ((2, 4), ("data", "model"))
B, S = 4, 32
# (case name, arch, moe_full_ep, fsdp at FSDP_MIN_BYTES = 0)
CASES = (("qwen2-moe", "qwen2-moe-a2.7b", False, False),
         ("mistral-nemo", "mistral-nemo-12b", False, False),
         ("jamba", "jamba-v0.1-52b", False, False),
         ("rwkv6", "rwkv6-3b", False, False),
         ("qwen2-moe-full-ep", "qwen2-moe-a2.7b", True, False),
         ("qwen2-moe-fsdp", "qwen2-moe-a2.7b", False, True))
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
# (case name, arch) of the decode cases
DECODE_CASES = (("starcoder2-decode", "starcoder2-3b"),
                ("rwkv6-decode", "rwkv6-3b"),
                ("deepseek-decode", "deepseek-v3-671b"))
DECODE_LEN, DECODE_INDEX = 16, 5
DECODE_TOL = 1e-4


def _flat(tree, prefix=""):
    """A nested dict / tuple of arrays -> {dotted path: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _jax_cache_by_layer(jcache):
    """The JAX cache (a tuple over the pattern, each leaf stacked over
    periods) -> {"<layer>.<path>": array}, the port's layer numbering."""
    period = len(jcache)
    out = {}
    for j, entry in enumerate(jcache):
        for path, leaf in _flat(entry).items():
            for n in range(leaf.shape[0]):
                out[f"{n * period + j}.{path}"] = np.asarray(leaf[n])
    return out


def _port_cache(template, flat, make):
    """The port's cache structure (``init_cache``'s, one entry per layer)
    with each leaf ``make(flat[name])``; pair caches are the JAX
    ``mixer`` tuples."""
    out = []
    for i, layer in enumerate(template):
        if isinstance(layer, tuple):
            out.append(tuple(make(flat[f"{i}.mixer.{j}"])
                             for j in range(len(layer))))
        else:
            out.append({part: {n: make(flat[f"{i}.{part}.{n}"])
                               for n in leaves}
                        for part, leaves in layer.items()})
    return out


def _decode_token():
    return np.random.RandomState(9).randint(0, 512, (B, 1)).astype(np.int32)


def _grad_names(names):
    """embed and the first expert weight (else the first mixer kernel)."""
    expert = [n for n in names if n.endswith("ffn.e_wg")]
    mixer = [n for n in names if n.startswith("layers.0.mixer.w")]
    return ["embed", (expert or sorted(mixer))[0]]


def _batch():
    r = np.random.RandomState(7)
    return {"tokens": r.randint(0, 512, (B, S)).astype(np.int32),
            "labels": r.randint(0, 512, (B, S)).astype(np.int32)}


def jax_side(out_dir):
    """The reference: one process, 8 host devices, every case."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import MeshConfig, smoke_config
    from repro.configs.base import ShapeConfig, StepKind
    from repro.dist import sharding as jsh
    from repro.launch.mesh import make_mesh
    from repro.models import Runtime, build_model
    from repro_torch.models.convert import transformer_params_from_jax

    mesh_cfg = MeshConfig(shape=MESH[0], axes=MESH[1])
    mesh = make_mesh(mesh_cfg)
    shape = ShapeConfig("tiny", seq_len=S, global_batch=B,
                        step=StepKind.TRAIN)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    for name, arch, full_ep, fsdp in CASES:
        cfg = smoke_config(arch).with_overrides(vocab_size=512)
        model = build_model(cfg, Runtime(tp_degree=4, moe_full_ep=full_ep))
        params = model.init(jax.random.PRNGKey(0))
        saved = jsh.FSDP_MIN_BYTES
        jsh.FSDP_MIN_BYTES = 0 if fsdp else saved
        try:
            pspecs = jsh.param_specs(jax.eval_shape(lambda: params), cfg,
                                     mesh_cfg, fsdp=fsdp)
        finally:
            jsh.FSDP_MIN_BYTES = saved
        bspecs = jsh.batch_specs(jax.eval_shape(lambda: batch), mesh_cfg,
                                 shape)
        put = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), params, pspecs)
        bput = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), batch, bspecs)
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: model.loss(p, b)[0]))(put, bput)
        sd = transformer_params_from_jax(jax.tree.map(np.asarray, params))
        gd = transformer_params_from_jax(jax.tree.map(np.asarray, grads))
        np.savez(os.path.join(out_dir, f"{name}.params.npz"),
                 **{k: v.numpy() for k, v in sd.items()})
        np.savez(os.path.join(out_dir, f"{name}.jax.npz"),
                 loss=np.float64(loss),
                 **{k: v.numpy() for k, v in gd.items()})
    np.savez(os.path.join(out_dir, "batch.npz"), **_batch())
    dshape = ShapeConfig("tiny-decode", seq_len=DECODE_LEN, global_batch=B,
                         step=StepKind.DECODE)
    for name, arch in DECODE_CASES:
        cfg = smoke_config(arch).with_overrides(vocab_size=512)
        model = build_model(cfg, Runtime(tp_degree=4))
        params = model.init(jax.random.PRNGKey(0))
        r = np.random.RandomState(11)
        cache = jax.tree.map(
            lambda x: jnp.asarray(0.5 * r.standard_normal(x.shape),
                                  x.dtype),
            model.init_cache(B, DECODE_LEN))
        flat_in = _jax_cache_by_layer(jax.tree.map(np.asarray, cache))
        pspecs = jsh.param_specs(jax.eval_shape(lambda: params), cfg,
                                 mesh_cfg)
        cspecs = jsh.cache_specs(jax.eval_shape(lambda: cache), cfg,
                                 mesh_cfg, dshape)
        put = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), params, pspecs)
        cput = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), cache, cspecs)
        tok = jnp.asarray(_decode_token())
        with mesh:
            logits, new = jax.jit(model.decode_step)(
                put, cput, tok, jnp.int32(DECODE_INDEX))
        sd = transformer_params_from_jax(jax.tree.map(np.asarray, params))
        np.savez(os.path.join(out_dir, f"{name}.params.npz"),
                 **{k: v.numpy() for k, v in sd.items()})
        np.savez(os.path.join(out_dir, f"{name}.cache.npz"), **flat_in)
        flat_out = _jax_cache_by_layer(jax.tree.map(np.asarray, new))
        np.savez(os.path.join(out_dir, f"{name}.jax.npz"),
                 logits=np.asarray(logits),
                 **{f"cache.{k}": v for k, v in flat_out.items()})


def torch_rank(rank, out_dir):
    """One of the 8 gloo ranks: every case on the 2 x 4 mesh."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import MeshConfig, ShapeConfig, StepKind
    from repro_torch.configs import smoke_config
    from repro_torch.dist import sharding as tsh
    from repro_torch.dist.axes import placements, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import Runtime

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD),
        rank=rank, world_size=WORLD)
    mesh_cfg = MeshConfig(shape=MESH[0], axes=MESH[1])
    mesh = make_mesh(mesh_cfg, "cpu")
    shape = ShapeConfig("tiny", seq_len=S, global_batch=B,
                        step=StepKind.TRAIN)
    nb = np.load(os.path.join(out_dir, "batch.npz"))
    bspecs = tsh.batch_specs(dict(nb), mesh_cfg, shape)
    batch = {k: distribute_tensor(torch.from_numpy(nb[k]).long(), mesh,
                                  placements(bspecs[k], mesh),
                                  src_data_rank=None) for k in nb}
    results = {}
    for name, arch, full_ep, fsdp in CASES:
        t0 = time.time()
        cfg = smoke_config(arch).with_overrides(vocab_size=512)
        model = build_model(cfg, Runtime(tp_degree=4, moe_full_ep=full_ep),
                            device="cpu")
        npz = np.load(os.path.join(out_dir, f"{name}.params.npz"))
        model.load_state_dict({k: torch.from_numpy(npz[k]) for k in npz},
                              strict=True)
        saved = tsh.FSDP_MIN_BYTES
        tsh.FSDP_MIN_BYTES = 0 if fsdp else saved
        try:
            specs = tsh.param_specs(model, cfg, mesh_cfg, fsdp=fsdp)
        finally:
            tsh.FSDP_MIN_BYTES = saved
        tsh.distribute_params(model, mesh, specs)
        with use_mesh(mesh):
            loss, _ = model.loss(batch)
            loss.backward()
        params = dict(model.named_parameters())
        out = {"loss": np.float64(loss.full_tensor().item())}
        for g, p in params.items():
            out[g] = p.grad.full_tensor().numpy()
        out["data_sharded"] = np.int64(sum(
            "data" in str(s) for s in specs.values()))
        out["seconds"] = np.float64(time.time() - t0)
        results[name] = out
    dshape = ShapeConfig("tiny-decode", seq_len=DECODE_LEN, global_batch=B,
                         step=StepKind.DECODE)
    tok = distribute_tensor(
        torch.from_numpy(_decode_token()), mesh,
        placements(tsh.batch_specs({"token": _decode_token()}, mesh_cfg,
                                   dshape)["token"], mesh),
        src_data_rank=None)
    for name, arch in DECODE_CASES:
        cfg = smoke_config(arch).with_overrides(vocab_size=512)
        model = build_model(cfg, Runtime(tp_degree=4), device="cpu")
        npz = np.load(os.path.join(out_dir, f"{name}.params.npz"))
        model.load_state_dict({k: torch.from_numpy(npz[k]) for k in npz},
                              strict=True)
        tsh.distribute_params(model, mesh,
                              tsh.param_specs(model, cfg, mesh_cfg))
        template = model.init_cache(B, DECODE_LEN)
        cspecs = tsh.cache_specs(template, cfg, mesh_cfg, dshape)
        flat = dict(np.load(os.path.join(out_dir, f"{name}.cache.npz")))
        # the port's cache structure with each leaf's flat name
        names = _port_cache(template, {k: k for k in flat}, lambda k: k)

        def place(n, spec):
            return distribute_tensor(torch.from_numpy(flat[n]), mesh,
                                     placements(spec, mesh),
                                     src_data_rank=None)

        cache = [tuple(place(n, sp) for n, sp in zip(ln, ls))
                 if isinstance(ln, tuple) else
                 {part: {k: place(ln[part][k], ls[part][k])
                         for k in ln[part]} for part in ln}
                 for ln, ls in zip(names, cspecs)]
        with use_mesh(mesh), torch.no_grad():
            logits, new = model.decode_step(cache, tok, DECODE_INDEX)
        out = {"logits": logits.full_tensor().numpy()}
        for ln, lc in zip(names, new):
            if isinstance(ln, tuple):
                pairs = zip(ln, lc)
            else:
                pairs = ((ln[p][k], lc[p][k]) for p in ln for k in ln[p])
            for n, t in pairs:
                out[f"cache.{n}"] = t.full_tensor().numpy()
        results[name] = out
    if rank == 0:
        for name, out in results.items():
            np.savez(os.path.join(out_dir, f"{name}.torch.npz"), **out)
    dist.destroy_process_group()


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist"))
    me = os.path.abspath(__file__)
    res = subprocess.run([sys.executable, me, "jax", out], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    procs = [subprocess.Popen([sys.executable, me, "rank", str(r), out],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append((p.returncode, err))
    bad = [e for rc, e in errs if rc != 0]
    assert not bad, bad[0][-3000:]
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_gloo_ranks_match_the_jax_sharded_run(runs, case):
    want = np.load(os.path.join(runs, f"{case}.jax.npz"))
    got = np.load(os.path.join(runs, f"{case}.torch.npz"))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    names = [k for k in want.files if k != "loss"]
    assert sorted(names) == sorted(k for k in got.files
                                   if k not in ("loss", "data_sharded",
                                                "seconds"))
    for n in _grad_names(names):
        assert float(np.abs(want[n]).max()) > 0, n
    for n in names:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= GRAD_TOL * scale, (n, err, scale)
    if case.endswith("fsdp"):
        assert int(got["data_sharded"]) > 0


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_gloo_ranks_decode_as_the_jax_sharded_run(runs, case):
    want = np.load(os.path.join(runs, f"{case}.jax.npz"))
    got = np.load(os.path.join(runs, f"{case}.torch.npz"))
    assert sorted(want.files) == sorted(got.files)
    assert any(k.startswith("cache.") for k in want.files)
    for n in want.files:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= DECODE_TOL * scale, (n, err, scale)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_side(sys.argv[2])
    else:
        torch_rank(int(sys.argv[2]), sys.argv[3])
