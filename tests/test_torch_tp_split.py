"""Tensor parallelism of the products the port splits on a sharded dim,
on fake process groups on the CPU (``launch/dryrun.py::fake_process_group``,
fake tensors: operations and collectives counted, no numbers).

``models/transformer.py::ffn_forward`` and ``models/mamba.py::mamba_forward``
split ``x @ wi`` / ``x @ in_proj`` (a column-parallel weight, its last dim
over "model") into gate and up halves. DTensor has no sharding rule for
that split, so it gathered the whole product on every rank.
``dist/regions.py::gated_product`` gives each rank the gate and up columns
of the rows of ``wo`` / ``out_proj`` it holds by one all-to-all over
"model" of whichever has fewer rows, its local product or its shard of the
weight. And where "model" has more ranks than KV heads (``wk`` / ``wv``
whole on every rank), ``models/attention.py::_kv_group_region`` has each
rank project a tp-th of K and V and the ranks sharing a head exchange
their slices.

Held here:

- ``ffn_forward`` with a backward and ``mamba_forward`` (a prefill with a
  backward, one decode step) on a (1, 4) ("data", "model") mesh, the model's
  parameters placed by ``param_specs``: no all-gather of the product (the
  decode step's only gathers are its new conv and ssm states, written into
  the cache's own layout, batch only as the reference's ``cache_specs``
  place it), the all-to-all bytes those of each rank's local product (128
  tokens, d = 128) or, at 256 tokens, of its weight shard, and the counted
  matmul operations a quarter of the (1, 1) mesh's;
- the smoke train cells from a (2, 1) to a (2, 4) mesh: operations a device
  fall by 3.9x or more for starcoder2-3b with no all-gather, by 3.35x or
  more for jamba at one period (the reference's own factor);
- both exchanges on 4 gloo ranks (this file run as ``... rank R DIR``):
  the FFN's and the mamba block's output and every gradient within 1e-5 of
  the plain block's max;
- ``gated_product`` on plain tensors is ``chunk`` of the product, and a
  split that the model degree does not divide raises, naming the shapes;
- the reference's microbatched step reduces each microbatch's weight
  gradients in bf16 inside the scan's while body: its nemo smoke train cell
  at 2 microbatches, bf16, on the 2 x 4 mesh, lowered by
  ``repro.launch.dryrun.lower_cell`` in a subprocess with 8 host devices
  (``... hlo DIR``) and read after XLA's SPMD partitioner (the compiled CPU
  text shows f32, from XLA:CPU's all-reduce-promotion pass, which widens
  every bf16 all-reduce). The port's ``train/train_step.py::_grad``
  reduces in the gradient's dtype too.
"""
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import (
    MeshConfig,
    ShapeConfig,
    StepKind,
    register,
    smoke_config,
)
from repro_torch.dist import regions
from repro_torch.dist.axes import placements, use_mesh
from repro_torch.dist.sharding import distribute_params, param_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import mamba as mb
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import ffn_forward
from repro_torch.perfmodel.counters import DeviceFlops
from repro_torch.perfmodel.hlo import CollectiveCounter

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B, S = 4, 32
TP = 4


@pytest.fixture(scope="module", autouse=True)
def _registry():
    """The smoke configs this module registers are taken out at its end."""
    import repro_torch.configs as tconfigs

    saved = dict(tconfigs._REGISTRY)
    yield
    tconfigs._REGISTRY.clear()
    tconfigs._REGISTRY.update(saved)


def _cfg(arch):
    cfg = smoke_config(arch)
    if cfg.mamba is not None:
        cfg = cfg.with_overrides(num_layers=cfg.interleave_period)
    return cfg


def _trace(arch, tp, fn):
    """``fn(model, cfg, mesh, place)`` on fake tensors, the smoke model's
    parameters placed by ``param_specs`` on a (1, ``tp``) mesh of a fake
    process group: (operations, collectives) of one device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mc = MeshConfig(shape=(1, tp), axes=("data", "model"))
    cfg = _cfg(arch)
    with dryrun.fake_process_group(mc.num_devices):
        mesh = make_mesh(mc, "cpu")

        def place(t, spec):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(t, mesh, placements(spec, mesh),
                                     src_data_rank=None)

        with FakeTensorMode():
            model = build_model(cfg, device="cpu")
            distribute_params(model, mesh, param_specs(model, cfg, mc))
            flops, coll = DeviceFlops(), CollectiveCounter()
            with flops, coll, use_mesh(mesh):
                fn(model, cfg, mesh, place)
    return flops.flops, coll.stats


def _stream(cfg, place, s=S):
    """A block's normed input, as the block places it: batch over "data",
    whole over "model"."""
    return place(torch.randn(B, s, cfg.d_model), ("data", None, None))


def _exchanged_bytes(cfg, width, s):
    """The bytes one all-to-all of ``gated_product`` moves from a rank
    (fp32): its local product (B s tokens) or, where the weight's shard
    has fewer rows (d), that shard, both ``width`` / tp columns."""
    return min(B * s, cfg.d_model) * width // TP * 4


@pytest.mark.parametrize("s", [S, 2 * S])
def test_ffn_keeps_the_product_sharded(s):
    """At 32 positions the 128 tokens are no more than d = 128, and the
    product is exchanged; at 64 the weight's shard."""
    def step(model, cfg, mesh, place):
        x = _stream(cfg, place, s).requires_grad_()
        y = regions.reduce_out(ffn_forward(model.layers[0].ffn, x, cfg))
        (y * y).sum().backward()

    f1, c1 = _trace("starcoder2-3b", 1, step)
    f4, c4 = _trace("starcoder2-3b", TP, step)
    cfg = _cfg("starcoder2-3b")
    assert c1.total_count == 0
    assert c4.count.get("all-gather", 0) == 0, c4.to_dict()
    assert c4.count["all-to-all"] == 2          # forward and backward
    assert c4.buffer_bytes["all-to-all"] == \
        2 * _exchanged_bytes(cfg, 2 * cfg.d_ff, s)
    assert f4 * TP == f1 > 0


def _mamba_layer(model):
    return next(b.mixer for b in model.layers
                if isinstance(b.mixer, mb.Mamba))


def _mamba_prefill(s):
    def step(model, cfg, mesh, place):
        x = _stream(cfg, place, s).requires_grad_()
        y, state = mb.mamba_forward(_mamba_layer(model), x, cfg,
                                    return_state=True)
        (regions.reduce_out(y) ** 2).sum().backward()
        assert set(state) == {"conv", "ssm"}

    return step


def _mamba_decode(model, cfg, mesh, place):
    cache = mb.init_mamba_cache(cfg, B, torch.float32, torch.device("cpu"))
    # the state caches' spec: batch only (``dist.sharding.cache_specs``)
    cache = {k: place(v, ("data",) + (None,) * (v.ndim - 1))
             for k, v in cache.items()}
    x = place(torch.randn(B, 1, cfg.d_model), ("data", None, None))
    with torch.no_grad():
        mb.mamba_forward(_mamba_layer(model), x, cfg, cache=cache)


@pytest.mark.parametrize("step,s", [("prefill", S), ("prefill", 2 * S),
                                    ("decode", 1)])
def test_mamba_keeps_the_in_projection_sharded(step, s):
    fn = _mamba_prefill(s) if step == "prefill" else _mamba_decode
    f1, c1 = _trace("jamba-v0.1-52b", 1, fn)
    f4, c4 = _trace("jamba-v0.1-52b", TP, fn)
    cfg = _cfg("jamba-v0.1-52b")
    di, n, dc, _ = mb._dims(cfg)
    passes = 2 if step == "prefill" else 1
    assert c1.total_count == 0
    assert c4.count["all-to-all"] == passes
    assert c4.buffer_bytes["all-to-all"] == \
        passes * _exchanged_bytes(cfg, 2 * di, s)
    # the decode step writes its new states back into the cache's layout
    # (whole channels); nothing else is gathered
    states = B * ((dc - 1) * di + di * n) * 4 if step == "decode" else 0
    assert c4.buffer_bytes.get("all-gather", 0) == states, c4.to_dict()
    assert f4 * TP == f1 > 0


TRAIN = ShapeConfig("smoke_train", seq_len=S, global_batch=B,
                    step=StepKind.TRAIN)


def _train_trace(arch, mesh_shape):
    mc = MeshConfig(shape=mesh_shape, axes=("data", "model"))
    cfg = register(_cfg(arch).with_overrides(name=f"{arch}-tp-split"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with dryrun.fake_process_group(mc.num_devices):
            mesh = make_mesh(mc, "cpu")
            run = dryrun.default_run(cfg, TRAIN, mc)
            return dryrun.trace_cell(cfg, run, mesh, "cpu", memory=False)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arch,factor,gathers", [
    ("starcoder2-3b", 3.9, 0), ("jamba-v0.1-52b", 3.35, None)])
def test_smoke_train_cell_scales_with_model_ranks(arch, factor, gathers):
    one, four = _train_trace(arch, (2, 1)), _train_trace(arch, (2, TP))
    assert one["flops"] >= factor * four["flops"], \
        (one["flops"], four["flops"])
    if gathers is not None:
        assert four["collectives"].count.get("all-gather", 0) == gathers, \
            four["collectives"].to_dict()


def test_gated_product_on_plain_tensors_is_chunk():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, generator=g)
    w = torch.randn(8, 12, generator=g)
    for got, want in zip(regions.gated_product(x, w),
                         (x @ w).chunk(2, dim=-1)):
        assert torch.equal(got, want)


def test_gated_product_refuses_a_split_the_model_degree_does_not_divide():
    from torch._subclasses.fake_tensor import FakeTensorMode

    mc = MeshConfig(shape=(1, TP), axes=("data", "model"))
    with dryrun.fake_process_group(mc.num_devices):
        mesh = make_mesh(mc, "cpu")
        with FakeTensorMode():
            from torch.distributed.tensor import distribute_tensor

            # 12 columns shard over 4 ranks; halves of 6 do not
            w = distribute_tensor(torch.zeros(8, 12), mesh,
                                  placements((None, "model"), mesh),
                                  src_data_rank=None)
            x = distribute_tensor(torch.zeros(2, 3, 8), mesh,
                                  placements((None, None, None), mesh),
                                  src_data_rank=None)
            with pytest.raises(ValueError, match=r"\(8, 12\).*6 columns"):
                regions.gated_product(x, w)


# ---------------------------------------------------------------------------
# numbers on real gloo ranks: both exchanges against the plain model

GLOO_WORLD = 4
GLOO_BATCH = 2
# positions: 2 x 8 tokens, fewer than d = 128 (the product is exchanged),
# and 2 x 128, more (the weight's shard)
GLOO_POSITIONS = (8, 128)
GLOO_TOL = 1e-5


def _block(arch, model):
    """The FFN of starcoder2-3b's layer 0, or jamba's first mamba mixer."""
    return model.layers[0].ffn if arch == "starcoder2-3b" \
        else _mamba_layer(model)


def _block_forward(arch, block, x, cfg):
    if arch == "starcoder2-3b":
        return ffn_forward(block, x, cfg)
    return mb.mamba_forward(block, x, cfg)[0]


def gloo_rank(rank, out_dir):
    """One of ``GLOO_WORLD`` gloo ranks on a (1, 4) mesh: the FFN and the
    mamba block, forward and backward, sharded and plain, on the same
    weights and inputs; rank 0 writes each gap relative to its max."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"),
                                     GLOO_WORLD),
        rank=rank, world_size=GLOO_WORLD)
    mc = MeshConfig(shape=(1, GLOO_WORLD), axes=("data", "model"))
    mesh = make_mesh(mc, "cpu")
    whole = placements((None, None, None), mesh)
    gaps = {}
    for arch in ("starcoder2-3b", "jamba-v0.1-52b"):
        cfg = _cfg(arch)
        plain = build_model(cfg, device="cpu", seed=0)
        model = build_model(cfg, device="cpu", seed=0)
        distribute_params(model, mesh, param_specs(model, cfg, mc))
        for s in GLOO_POSITIONS:
            gen = torch.Generator().manual_seed(s)
            x0 = torch.randn(GLOO_BATCH, s, cfg.d_model, generator=gen)
            r0 = torch.randn(GLOO_BATCH, s, cfg.d_model, generator=gen)
            want_blk, got_blk = _block(arch, plain), _block(arch, model)
            for p in list(want_blk.parameters()) + list(got_blk.parameters()):
                p.grad = None
            xp = x0.clone().requires_grad_()
            yp = _block_forward(arch, want_blk, xp, cfg)
            (yp * r0).sum().backward()
            xd = distribute_tensor(x0, mesh, whole,
                                   src_data_rank=None).requires_grad_()
            yd = regions.reduce_out(_block_forward(arch, got_blk, xd, cfg))
            (yd * distribute_tensor(r0, mesh, whole,
                                    src_data_rank=None)).sum().backward()
            pairs = [("y", yp, yd), ("x.grad", xp.grad, xd.grad)]
            pairs += [(n + ".grad", p.grad, q.grad) for (n, p), q in zip(
                want_blk.named_parameters(), got_blk.parameters())]
            for name, want, got in pairs:
                got = got.full_tensor()
                scale = float(want.abs().max())
                assert scale > 0, (arch, s, name)
                gaps[f"{arch}/{s}/{name}"] = np.float64(
                    float((got - want).abs().max()) / scale)
    if rank == 0:
        np.savez(os.path.join(out_dir, "gaps.npz"), **gaps)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_gaps(tmp_path_factory):
    import numpy as np

    out = str(tmp_path_factory.mktemp("gloo"))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "rank", str(r), out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(GLOO_WORLD)]
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
    return dict(np.load(os.path.join(out, "gaps.npz")))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("s", GLOO_POSITIONS)
def test_gloo_ranks_match_the_plain_block(gloo_gaps, arch, s):
    """The sharded block's output, its input's gradient and every weight's
    gradient within ``GLOO_TOL`` of the plain block's max, on both
    exchanges (the product's at 8 positions, the weight's at 128)."""
    mine = {k: v for k, v in gloo_gaps.items()
            if k.startswith(f"{arch}/{s}/")}
    assert len(mine) >= 4 and f"{arch}/{s}/x.grad" in mine
    assert all(v <= GLOO_TOL for v in mine.values()), mine


# ---------------------------------------------------------------------------
# the reference's gradient reductions in its microbatch scan


def reference_hlo(out_dir):
    """The reference's nemo smoke train cell at 2 microbatches (bf16, the
    run's default dtypes) on the 2 x 4 mesh, lowered and compiled with XLA
    dumping the module after SPMD partitioning into ``out_dir``."""
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        f"--xla_dump_to={out_dir} --xla_dump_hlo_as_text "
        "--xla_dump_hlo_module_re=train_step "
        "--xla_dump_hlo_pass_re=spmd-partitioning")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro.configs import MeshConfig as JMesh, smoke_config as jsmoke
    from repro.configs.base import ShapeConfig as JShape, StepKind as JStep
    from repro.launch import dryrun as jd
    from repro.launch.mesh import make_mesh as jmesh

    mc = JMesh(shape=(2, 4), axes=("data", "model"))
    cfg = jsmoke("mistral-nemo-12b")
    shape = JShape("smoke_train", seq_len=S, global_batch=B,
                   step=JStep.TRAIN)
    run = jd.default_run(cfg, shape, mc, microbatches=2)
    assert (run.param_dtype, run.compute_dtype) == ("bfloat16", "bfloat16")
    txt = jd.lower_cell(cfg, run, jmesh(mc), roofline=False).compile() \
        .as_text()
    with open(os.path.join(out_dir, "compiled.txt"), "w") as f:
        f.write(txt)


def _computations(txt):
    comps, cur = {}, None
    for line in txt.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if m:
            cur = m.group(1)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
    return comps


def _in_while_bodies(comps):
    """The computations a while loop's body runs, transitively."""
    called = {n: set(re.findall(
        r"(?:to_apply|body|condition|calls)=%?([\w.\-]+)", "\n".join(ls)))
        for n, ls in comps.items()}
    todo = [m.group(1) for ls in comps.values() for line in ls
            for m in [re.search(r"\bwhile\(.*body=%?([\w.\-]+)", line)] if m]
    inside = set()
    while todo:
        n = todo.pop()
        if n in comps and n not in inside:
            inside.add(n)
            todo.extend(called[n])
    return inside


_REDUCTION = re.compile(r"= (\w+)\[([\d,]*)\][^=]*\b(all-reduce|"
                        r"reduce-scatter)\(%(dot|scatter)\b")


@pytest.fixture(scope="module")
def reference_reductions(tmp_path_factory):
    """{(in a while body, element type, kind, rank)} of the reference's
    weight-gradient reductions (the operand a dot or the embedding's
    scatter), after SPMD partitioning, and the compiled CPU text."""
    out = str(tmp_path_factory.mktemp("hlo"))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "hlo",
                          out], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    path, = glob.glob(os.path.join(
        out, "*train_step*after_spmd-partitioning*.txt"))
    with open(path) as f:
        comps = _computations(f.read())
    inside = _in_while_bodies(comps)
    found = set()
    for name, lines in comps.items():
        for line in lines:
            m = _REDUCTION.search(line)
            if m:
                found.add((name in inside, m.group(1), m.group(3),
                           len(m.group(2).split(","))))
    with open(os.path.join(out, "compiled.txt")) as f:
        return found, f.read()


def test_reference_reduces_each_microbatch_gradient_in_bf16(
        reference_reductions):
    """Faults item 5's verdict: the port's per-microbatch reduction in the
    gradient's dtype is the reference's. Every weight-gradient all-reduce
    of the partitioned step lies in the microbatch scan's body and is
    bf16; the compiled CPU text has widened them all to f32."""
    found, compiled = reference_reductions
    weights = {f for f in found if f[3] == 2}
    assert weights and all(inside and dtype == "bf16"
                           for inside, dtype, _, _ in weights), found
    assert not re.search(r"= bf16\[[\d,]*\][^=]*\ball-reduce\(", compiled)
    assert "_promoted" in compiled


if __name__ == "__main__":
    if sys.argv[1] == "hlo":
        reference_hlo(sys.argv[2])
    else:
        gloo_rank(int(sys.argv[2]), sys.argv[3])
