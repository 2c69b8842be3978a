"""The dry run on fake tensors (``repro_torch.launch.dryrun``) against the
JAX package's, on the CPU.

Seven archs, one of each family (dense, MoE, MLA with MTP, rwkv, the
mamba hybrid at one period, llava's image patches, whisper), at
``smoke_config`` size, each traced for a train step, a prefill and a
decode step (batch 4, 32 positions) on a 2 x 4 ("data", "model") mesh of
a fake process group, on the plain path (``device="cpu"``). Held to the
reference, where the reference is analytic or its specs decide:

- ``input_specs`` of every arch and shape at full size: equal;
- the records' keys: the reference's, in both modes;
- ``argument_bytes``: equal to the per-device bytes of the reference's
  ``jax.eval_shape`` trees under its ``param_specs`` / ``batch_specs`` /
  ``cache_specs`` (no XLA compile);
- the analytic wire bytes: equal to the reference's
  ``cell_collective_projection``;
- the measured (traced) wire bytes: within the reference's 0.75 gate on
  the all-reduce kinds (``benchmarks/dryrun_summary.py --max-rel-error``);
- roofline mode's extrapolated operations (and, over depth, collective
  bytes): equal to a full-depth trace's (three periods; four
  microbatches).

Then the kernels' ops: a fake trace on ``cuda`` tensors with no mesh goes
through each of the four ops (its fake calls move, its launches stay 0),
and each op's registered operation count equals what ``chip_smoke.py``'s
bound takes at one shape. Last, ``examples/characterize_arch_torch.py``'s
SeqPoint SLs equal the reference example's step (1).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import (
    MeshConfig,
    ShapeConfig,
    StepKind,
    get_model_config,
    register,
    smoke_config,
)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model_zoo import build_model

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MESH = MeshConfig(shape=(2, 4), axes=("data", "model"))
B, S = 4, 32
FAMILIES = {"dense": "starcoder2-3b", "moe": "qwen2-moe-a2.7b",
            "mla-mtp": "deepseek-v3-671b", "rwkv": "rwkv6-3b",
            "hybrid": "jamba-v0.1-52b", "patches": "llava-next-34b",
            "encdec": "whisper-medium"}
STEPS = {"train": StepKind.TRAIN, "prefill": StepKind.PREFILL,
         "decode": StepKind.DECODE}
CELLS = [(f, s) for f in FAMILIES for s in STEPS]
GATE = 0.75                  # benchmarks/dryrun_summary.py --max-rel-error
COMPILE_KEYS = {"arch", "shape", "mesh", "mode", "status", "memory",
                "flops", "bytes", "collectives", "projection", "seconds"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "live_bytes_per_device", "fits_v5e_16g", "ckpt_bytes",
               "working_bytes", "structural_bytes", "fits_v5e_16g_structural"}
ROOFLINE_KEYS = {"arch", "shape", "mesh", "mode", "status", "flops",
                 "bytes_xla_cpu", "bytes", "collectives", "wire_bytes",
                 "projection", "terms", "dominant", "model_flops_total",
                 "model_flops_per_chip", "useful_flops_ratio",
                 "roofline_fraction", "seconds"}


def _smoke(configs, arch):
    """The family's smoke config in one package (``configs`` is
    ``repro.configs`` or ``repro_torch.configs``): the hybrid at one
    period; whisper with 16 frames, fewer than its 32 tokens as in
    production (1500 frames, 32768 tokens at prefill_32k): the analytic
    wire model prices decoder tokens only, so an encoder twice as long as
    the decoder's input would sit outside it."""
    cfg = configs.smoke_config(arch)
    if cfg.mamba is not None:
        cfg = cfg.with_overrides(num_layers=cfg.interleave_period)
    if cfg.encoder is not None:
        cfg = cfg.with_overrides(encoder=dataclasses.replace(
            cfg.encoder, max_source_len=16))
    return cfg


def _shape(step):
    return ShapeConfig(f"smoke_{step}", seq_len=S, global_batch=B,
                       step=STEPS[step])


@pytest.fixture
def jdryrun(monkeypatch):
    """The reference's ``repro.launch.dryrun``, imported without changing
    the worker's ``XLA_FLAGS`` (its import would set 512 host devices)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jd

    return jd


@pytest.fixture(scope="module")
def records():
    """Every cell traced once in compile mode, the dense train cell also
    in roofline mode, and the deeper cell of the extrapolation test."""
    import repro_torch.configs as tconfigs

    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with dryrun.fake_process_group(MESH.num_devices):
        mesh = make_mesh(MESH, "cpu")
        for fam, arch in FAMILIES.items():
            name = register(_smoke(tconfigs, arch)).name
            for step in STEPS:
                out[(fam, step, "compile")] = dryrun.run_cell(
                    name, _shape(step), MESH, mesh, "compile", "cpu")
        out[("dense", "train", "roofline")] = dryrun.run_cell(
            register(_smoke(tconfigs, FAMILIES["dense"])).name,
            _shape("train"), MESH, mesh, "roofline", "cpu")
        deep = register(smoke_config("starcoder2-3b").with_overrides(
            name="starcoder2-3b-smoke-deep", num_layers=3))
        for micro, batch in ((1, B), (4, 8)):
            shape = ShapeConfig(f"smoke_micro{micro}", seq_len=S,
                                global_batch=batch, step=StepKind.TRAIN)
            for mode in ("compile", "roofline"):
                out[("deep", micro, mode)] = dryrun.run_cell(
                    deep.name, shape, MESH, mesh, mode, "cpu",
                    microbatches=micro)
    torch.set_num_threads(threads)
    return out


def _ok(rec):
    assert rec["status"] == "ok", rec.get("error", "") + \
        rec.get("traceback", "")
    return rec


# ---------------------------------------------------------------------------
# specs and records


@pytest.mark.parametrize("arch", sorted(set(FAMILIES.values()) | {
    "mistral-nemo-12b", "internlm2-20b", "qwen2-72b"}))
def test_input_specs_match_the_reference(arch):
    import jax.numpy as jnp

    from repro.configs import get_model_config as j_cfg
    from repro.configs import shapes_for
    from repro.models import Runtime as JRuntime
    from repro.models import build_model as j_build
    from repro_torch.models.transformer import Runtime

    jm = j_build(j_cfg(arch), JRuntime(param_dtype=jnp.bfloat16,
                                       compute_dtype=jnp.bfloat16))
    tm = build_model(get_model_config(arch),
                     Runtime(param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16), device="meta")
    for shape in shapes_for(j_cfg(arch)):
        want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in jm.input_specs(shape).items()}
        got = {k: (tuple(s), str(d).replace("torch.", ""))
               for k, (s, d) in tm.input_specs(shape).items()}
        assert got == want, shape.name


@pytest.mark.parametrize("fam,step", CELLS)
def test_records_have_the_reference_keys(records, fam, step):
    rec = _ok(records[(fam, step, "compile")])
    assert COMPILE_KEYS <= set(rec)
    assert MEMORY_KEYS <= set(rec["memory"])
    mem = rec["memory"]
    assert mem["live_bytes_per_device"] >= mem["argument_bytes"] > 0
    assert rec["flops"] > 0
    # the plain path launches and fakes no kernel
    assert set(rec["kernel_calls"].values()) == {0}
    if (fam, step, "roofline") in records:
        roof = _ok(records[(fam, step, "roofline")])
        assert ROOFLINE_KEYS <= set(roof)
        assert {"terms_h100", "roofline_fraction_h100"} <= set(roof)
        assert set(roof["terms"]) == set(roof["terms_h100"]) \
            == {"compute_s", "memory_s", "collective_s"}


def _ref_cell(jd, fam, step):
    """The reference's config, run and model for a cell."""
    import repro.configs as jconfigs
    from repro.configs import MeshConfig as JMesh
    from repro.configs import ShapeConfig as JShape
    from repro.configs import StepKind as JStep
    from repro.models.model_zoo import build_model as j_build

    cfg = _smoke(jconfigs, FAMILIES[fam])
    shape = JShape(f"smoke_{step}", seq_len=S, global_batch=B,
                   step=JStep(STEPS[step].value))
    run = jd.default_run(cfg, shape, JMesh(shape=MESH.shape, axes=MESH.axes))
    model = j_build(cfg, jd._runtime(run, False, jd._n_periods(cfg)))
    return cfg, shape, run, model


def _per_device_bytes(tree, specs, mesh):
    """Bytes one device holds of ``tree`` (ShapeDtypeStructs) placed by
    ``specs`` (PartitionSpecs) on ``mesh`` (a MeshConfig)."""
    import jax
    from jax.sharding import PartitionSpec as P

    extent = dict(zip(mesh.axes, mesh.shape))
    total = 0
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        shards = 1
        for entry in spec:
            for a in () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry):
                shards *= extent[a]
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        assert n % shards == 0
        total += n // shards
    return total


@pytest.mark.parametrize("fam,step", CELLS)
def test_argument_bytes_match_the_reference_specs(records, jdryrun, fam,
                                                  step):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.dist.sharding import batch_specs, cache_specs, param_specs
    from repro.train.optimizer import OptState
    from repro.train.train_step import TrainState, init_train_state

    cfg, shape, run, model = _ref_cell(jdryrun, fam, step)
    mesh = run.mesh
    rng = jax.random.PRNGKey(0)
    if step == "train":
        state = jax.eval_shape(lambda r: init_train_state(model, run, r),
                               rng)
        pspecs = param_specs(state.params, cfg, mesh,
                             run.fsdp and run.zero_stage >= 3,
                             run.fsdp_over_pods, run.moe_full_ep,
                             run.parallelism)
        ospecs = param_specs(state.params, cfg, mesh, run.fsdp,
                             run.fsdp_over_pods, run.moe_full_ep,
                             run.parallelism)
        specs = TrainState(params=pspecs,
                           opt=OptState(step=P(), m=ospecs, v=ospecs),
                           ef=ospecs if state.ef is not None else None)
        batch = model.input_specs(shape)
        want = (_per_device_bytes(state, specs, mesh)
                + _per_device_bytes(batch, batch_specs(
                    batch, mesh, shape, run.parallelism), mesh))
    else:
        params = jax.eval_shape(model.init, rng)
        want = _per_device_bytes(params, param_specs(
            params, cfg, mesh, fsdp=run.fsdp,
            fsdp_over_pods=run.fsdp_over_pods, moe_full_ep=run.moe_full_ep,
            parallelism=run.parallelism), mesh)
        inputs = model.input_specs(shape)
        want += _per_device_bytes(inputs, batch_specs(inputs, mesh, shape),
                                  mesh)
        if step == "decode":
            cache = jax.eval_shape(lambda: model.init_cache(B, S))
            want += _per_device_bytes(cache, cache_specs(cache, cfg, mesh,
                                                         shape), mesh)
    rec = _ok(records[(fam, step, "compile")])
    assert rec["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("fam,step", CELLS)
def test_analytic_wire_bytes_match_the_reference(records, jdryrun, fam,
                                                 step):
    from repro.obs.projection import cell_collective_projection
    from repro.perfmodel.hlo import CollectiveStats

    cfg, shape, run, _ = _ref_cell(jdryrun, fam, step)
    want = cell_collective_projection(
        cfg, shape, run, CollectiveStats(),
        dp_reduce_elems=jdryrun._dp_reduce_elems(cfg, run))
    got = _ok(records[(fam, step, "compile")])["projection"]
    for k in ("analytic_dp_bytes", "analytic_tp_bytes",
              "analytic_wire_bytes", "dp_degree", "tp_degree",
              "grad_dtype_bytes", "micro_reduces", "dp_reduce_elems"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("fam,step", CELLS)
def test_measured_wire_bytes_within_the_gate(records, fam, step):
    proj = _ok(records[(fam, step, "compile")])["projection"]
    assert proj["measured_claimed_wire_bytes"] > 0
    assert proj["rel_error_claimed"] <= GATE, proj


@pytest.mark.parametrize("micro", [1, 4])
def test_roofline_extrapolation_equals_a_full_depth_trace(records, micro):
    """Over depth (three periods from one and two) the extrapolation is
    exact for operations and collectives; over microbatches (four from one
    and two) for operations only: DTensor picks its redistributions by the
    microbatch's shape, so a cell's collectives are not bilinear in the
    microbatch count (at this size 70 all-gathers extrapolated against 64
    traced)."""
    full = _ok(records[("deep", micro, "compile")])
    roof = _ok(records[("deep", micro, "roofline")])
    assert roof["flops"] == full["flops"] > 0
    if micro == 1:
        assert roof["collectives"] == full["collectives"]
    assert roof["projection"]["analytic_wire_bytes"] \
        == full["projection"]["analytic_wire_bytes"]


def test_decode_and_train_update_their_arguments_in_place(records):
    for fam in FAMILIES:
        train = records[(fam, "train", "compile")]["memory"]
        decode = records[(fam, "decode", "compile")]["memory"]
        prefill = records[(fam, "prefill", "compile")]["memory"]
        assert 0 < train["alias_bytes"] < train["argument_bytes"]
        assert 0 < decode["alias_bytes"] < decode["argument_bytes"]
        assert prefill["alias_bytes"] == 0


def test_fake_process_group_refuses_a_second_group():
    with dryrun.fake_process_group(8):
        with pytest.raises(RuntimeError):
            with dryrun.fake_process_group(8):
                pass
    import torch.distributed as dist

    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the kernels as ops a fake trace follows


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    return cs


def _count(monkeypatch, cs, fn, *args):
    """``fn``'s least time with the card's byte rate set infinite: the
    operations' time alone, and from it the operation count at the fp32
    peak."""
    monkeypatch.setattr(cs, "HBM_BYTES_PER_S", float("inf"))
    ms, by = fn(*args)
    assert by == "operations"
    return ms * 1e-3


def _fake_call(kernel, fn, *args):
    """One call of ``fn`` on fake ``cuda`` tensors under a per-device
    counter: (operations, the kernel's fake calls, its launches)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.perfmodel.counters import DeviceFlops

    kernel.fake_calls = 0
    launches = kernel.launches
    with FakeTensorMode():
        made = [torch.empty(s, dtype=d, device="cuda")
                if isinstance(s, tuple) else s for s, d in args]
        with DeviceFlops() as flops:
            out = fn(*made)
    assert all(t.device.type == "cuda" for t in
               torch.utils._pytree.tree_leaves(out))
    return flops.flops, kernel.fake_calls, kernel.launches - launches


def test_flash_op_follows_a_fake_trace(monkeypatch, chip_smoke):
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention

    bf = torch.bfloat16
    b, sq, skv, hq, hkv, dh = 2, 48, 80, 8, 2, 64
    flops, calls, launches = _fake_call(
        kernel, flash_attention, ((b, sq, hq, dh), bf),
        ((b, skv, hkv, dh), bf), ((b, skv, hkv, dh), bf), (True, None))
    assert (calls, launches) == (1, 0)
    t = _count(monkeypatch, chip_smoke, chip_smoke.flash_bound_ms, b * hq,
               b * hkv, sq, skv, dh, True, bf)
    assert flops == pytest.approx(t * chip_smoke.BF16_FLOPS_PER_S,
                                  rel=1e-12)
    assert flops == 4 * b * hq * dh * chip_smoke.flash_pairs(sq, skv, True)


def test_lstm_op_follows_a_fake_trace(monkeypatch, chip_smoke):
    from repro_torch.kernels.lstm_cell import kernel
    from repro_torch.kernels.lstm_cell.ops import lstm_cell

    bsz, k, h = 16, 2048, 1024
    f32 = torch.float32
    flops, calls, launches = _fake_call(
        kernel, lstm_cell, ((bsz, k), f32), ((k, h, 4), f32),
        ((h, 4), f32), ((bsz, h), f32))
    assert (calls, launches) == (1, 0)
    t = _count(monkeypatch, chip_smoke, chip_smoke.cell_bound_ms, bsz, k, h)
    assert flops == pytest.approx(t * chip_smoke.FP32_FLOPS_PER_S,
                                  rel=1e-12)


def test_wkv6_op_follows_a_fake_trace(chip_smoke):
    from repro_torch.kernels.rwkv6_wkv import kernel
    from repro_torch.kernels.rwkv6_wkv.ops import wkv6

    b, s, h, dh = 2, 96, 4, 64
    x = ((b, s, h, dh), torch.float32)
    flops, calls, launches = _fake_call(
        kernel, wkv6, x, x, x, x, ((h, dh), torch.float32), (None, None))
    assert (calls, launches) == (1, 0)
    assert flops == chip_smoke.wkv6_bound_ms(b, s, h, dh, False)[3]


def test_mamba_op_follows_a_fake_trace(chip_smoke):
    from repro_torch.kernels.mamba_scan import kernel
    from repro_torch.kernels.mamba_scan.ops import mamba_scan

    b, s, d, n = 2, 40, 256, 16
    bf, f32 = torch.bfloat16, torch.float32
    flops, calls, launches = _fake_call(
        kernel, mamba_scan, ((b, s, d), bf), ((b, s, d), f32),
        ((d, n), f32), ((b, s, n), bf), ((b, s, n), bf), ((d,), bf),
        ((b, d, n), f32))
    assert (calls, launches) == (1, 0)
    bound = chip_smoke.mamba_bound_ms(b, s, d, n, 2, True)
    assert flops == bound[3] + bound[4]          # fp32 operations + exps


# ---------------------------------------------------------------------------
# the characterization example


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-3b"])
def test_characterize_selects_the_reference_seqpoints(arch):
    from repro.configs import SINGLE_POD as J_SINGLE
    from repro.configs import get_model_config as j_cfg
    from repro.core import EpochLog, select_seqpoints
    from repro.data.batching import plan_epoch
    from repro.data.synthetic import lm_documents
    from repro.perfmodel.machine import TPU_V5E
    from repro.perfmodel.model_flops import param_count

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import characterize_arch_torch as ex
    finally:
        sys.path.pop(0)
    samples, batch, max_sl, gran = 2048, 16, 4096, 256
    # the reference example's step (1), as it stands there
    rng = np.random.RandomState(0)
    sls = lm_documents(max_sl).sample(rng, samples)
    plan = plan_epoch(sls, batch, granularity=gran)
    n_active = param_count(j_cfg(arch), active=True)
    log = EpochLog()
    for sl in plan.padded_sls:
        log.append(int(sl), 6 * n_active * batch * int(sl)
                   / J_SINGLE.num_devices / TPU_V5E.peak_flops)
    want = select_seqpoints(log, error_threshold=0.02)
    tplan, got = ex.proxy_seqpoints(arch, samples, batch, max_sl, gran)
    assert list(tplan.padded_sls) == list(plan.padded_sls)
    assert got.seq_lens == want.seq_lens
    assert np.allclose(got.weights, want.weights, rtol=0, atol=0)
    assert 0 < got.num_points < len(set(plan.padded_sls))
