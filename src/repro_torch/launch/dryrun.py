"""Multi-pod dry run on fake tensors, a port of ``repro.launch.dryrun``:
trace every (arch x shape x mesh) cell's step on one process.

The reference lowers and compiles each cell with XLA on 512 host devices.
The port traces the step it would run on the card instead: one process
joins a ``"fake"`` process group of the mesh's size as rank 0
(``fake_process_group``), builds the mesh, and under ``FakeTensorMode``
(no memory, no numbers) builds the model, the train state or the cache and
the inputs from ``input_specs``, places them as DTensors by the production
rules (``param_specs``, ``batch_specs``, ``cache_specs``, as the reference
places its ``ShapeDtypeStruct``s) and runs one train step, one prefill or
one decode step, every op of it, under three per-device counters
(``perfmodel.counters``, ``perfmodel.hlo.CollectiveCounter``). On a card
(``device="cuda"``, the default) the trace takes the card's own path: the
kernels are the ops of ``kernels/*/ops.py``, whose fake versions count
the calls a real step would launch (a train step's backward kernels
among them). ``device="cpu"`` traces the plain path.

Modes:
  compile  — the whole step at full depth, both meshes: ``memory`` (the
             trace's per-device peak, the arguments, outputs and the state
             or cache updated in place; the reference's analytic
             ``structural_*`` fields beside them), ``flops`` (counted),
             ``bytes`` (the analytic traffic model, as the reference's
             roofline mode prices it), ``collectives`` (counted) and the
             analytic-vs-measured ``projection``.
  roofline — the reference's bilinear extrapolation over (periods k,
             microbatches m) in {1, 2}^2, exact for counted operations and
             collective bytes; the terms on the reference's TPU_V5E and on
             the H100 (``terms_h100``).

Usage:
  python -m repro_torch.launch.dryrun --mode compile --mesh both
  python -m repro_torch.launch.dryrun --mode roofline --arch rwkv6-3b \\
      --shape train_4k [--device cpu]

A fake-tensor peak is not XLA's ``temp_size``: the two count different
programs (eager ops with their own temporaries against a fused, scheduled
module), so the port's memory is not compared with the reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Union

import torch

from repro_torch.configs import (
    MULTI_POD,
    SINGLE_POD,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
    get_model_config,
    get_shape,
    list_archs,
    shapes_for,
)
from repro_torch.dist.axes import placements, set_dp_axes, use_mesh
from repro_torch.dist.compression import uses_error_feedback
from repro_torch.dist.regions import is_dtensor
from repro_torch.dist.sharding import (
    batch_specs,
    cache_specs,
    distribute_params,
    dp_grad_reduce_elems,
    param_specs,
)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.mamba_scan import kernel as mamba_kernel
from repro_torch.kernels.rwkv6_wkv import kernel as wkv6_kernel
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import Runtime
from repro_torch.obs.projection import (
    cell_collective_projection,
    collective_projection_report,
)
from repro_torch.perfmodel.counters import DeviceFlops, PeakMemory
from repro_torch.perfmodel.hlo import CollectiveCounter, CollectiveStats
from repro_torch.perfmodel.machine import (
    H100_HBM_GB,
    H100_SXM_BF16,
    TPU_V5E,
    TPU_V5E_HBM_GB,
)
from repro_torch.perfmodel.memory import structural_memory
from repro_torch.perfmodel.model_flops import model_flops, param_count
from repro_torch.perfmodel.traffic import hbm_traffic
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState, build_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results")

# the kernels whose fake calls a trace counts, by the name chip_smoke.py
# gives them: each kernel module and its counter (a backward kernel's
# beside its forward's)
KERNELS = {"lstm_cell": (lstm_kernel, "fake_calls"),
           "lstm_cell_bwd": (lstm_kernel, "bwd_fake_calls"),
           "flash_attention": (flash_kernel, "fake_calls"),
           "flash_attention_bwd": (flash_kernel, "bwd_fake_calls"),
           "wkv6": (wkv6_kernel, "fake_calls"),
           "wkv6_bwd": (wkv6_kernel, "bwd_fake_calls"),
           "mamba_scan": (mamba_kernel, "fake_calls"),
           "mamba_scan_bwd": (mamba_kernel, "bwd_fake_calls")}

# the reference's OptState.step, a 4-byte scalar on the device; the port's
# is a host int
_STEP_BYTES = 4


def default_run(cfg: ModelConfig, shape: ShapeConfig,
                mesh: MeshConfig, **overrides) -> RunConfig:
    """Production defaults per cell, the reference's rules."""
    n_total = param_count(cfg, active=False)
    moment_dtype = "bfloat16" if n_total > 100e9 else "float32"
    is_train = shape.step == StepKind.TRAIN
    dp_degree = (mesh.num_devices
                 if overrides.get("parallelism") == "dp_only"
                 else mesh.data_degree)
    # gradient accumulation keeps backward residuals bounded: the smallest
    # power of two keeping per-device remat checkpoints <~4 GB
    nmicro = overrides.pop("microbatches", 0)
    if not nmicro:
        nmicro = 1
        if is_train:
            # remat checkpoints shard over the batch (dp) axis only
            ckpt_bytes = (cfg.num_layers * shape.global_batch
                          * shape.seq_len * cfg.d_model * 2 / dp_degree)
            target = 4 * 2**30
            while (nmicro < shape.global_batch // dp_degree
                   and ckpt_bytes / nmicro > target):
                nmicro *= 2
    kw: Dict[str, Any] = dict(
        model=cfg, shape=shape, mesh=mesh,
        optimizer=OptimizerConfig(moment_dtype=moment_dtype),
        # >100B archs need ZeRO-style storage sharding even at serving
        fsdp=is_train or n_total > 100e9,
        fsdp_over_pods=n_total > 100e9,
        remat="block" if is_train else "none",
        microbatches=nmicro,
    )
    kw.update(overrides)
    return RunConfig(**kw)


def _runtime(run: RunConfig) -> Runtime:
    """The run's ``Runtime``; the reference's roofline unrolling has no
    counterpart (the port's layer loop is eager)."""
    return Runtime.from_run(run)


def _reduced(cfg: ModelConfig, k: int) -> ModelConfig:
    """k interleave periods of depth (for roofline extrapolation)."""
    if cfg.encoder is not None:
        return cfg.with_overrides(
            num_layers=k,
            encoder=dataclasses.replace(cfg.encoder, num_layers=k))
    return cfg.with_overrides(num_layers=k * cfg.interleave_period)


def _n_periods(cfg: ModelConfig) -> int:
    if cfg.encoder is not None:
        return cfg.num_layers
    return cfg.num_layers // cfg.interleave_period


def _param_specs(model, cfg: ModelConfig, run: RunConfig,
                 fsdp: bool) -> Dict[str, Any]:
    return param_specs(model, cfg, run.mesh, fsdp, run.fsdp_over_pods,
                       run.moe_full_ep, run.parallelism)


def _dp_reduce_elems(cfg: ModelConfig, run: RunConfig) -> Optional[float]:
    """Per-device DP-ring gradient elements for the projection's analytic
    dp term, from the cell's real spec tree (None for non-train steps)."""
    if run.shape.step != StepKind.TRAIN:
        return None
    model = build_model(cfg, _runtime(run), device="meta")
    pspecs = _param_specs(model, cfg, run, run.fsdp and run.zero_stage >= 3)
    return dp_grad_reduce_elems(model, pspecs, run.mesh)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A ``"fake"`` process group of ``world_size`` ranks with this process
    as rank 0, for the ``with`` block: collectives return at once and move
    nothing, so one process traces a rank of a mesh of any size. The group
    is destroyed on exit. Its store is a private module of torch's tests,
    used here and nowhere else."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _place(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def local_bytes(t) -> int:
    """One device's bytes of a tensor (a DTensor's local shard)."""
    if is_dtensor(t):
        t = t.to_local()
    return t.numel() * t.element_size()


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _tree_bytes(tree) -> int:
    return sum(local_bytes(t) for t in _leaves(tree))


@dataclasses.dataclass
class Cell:
    """One cell's step, built and placed: ``run()`` takes the step once.
    ``arguments`` are the step's inputs (state or parameters, batch or
    cache) and ``aliased`` the part the step updates in place."""

    run: Any
    arguments: list
    argument_bytes: int
    alias_bytes: int


def build_cell(cfg: ModelConfig, run: RunConfig, mesh, device) -> Cell:
    """The model, its state or cache and its inputs for ``run.shape``'s
    step, placed on ``mesh`` as the reference places them. Under
    ``FakeTensorMode`` nothing is allocated; on a card outside it the same
    cell is real."""
    shape = run.shape
    model = build_model(cfg, _runtime(run), device=device, seed=run.seed)
    specs = model.input_specs(shape)
    inputs = {k: torch.zeros(s, dtype=d, device=device)
              for k, (s, d) in specs.items()}
    if shape.step == StepKind.TRAIN:
        pspecs = _param_specs(model, cfg, run,
                              run.fsdp and run.zero_stage >= 3)
        # ZeRO-1: optimizer moments sharded even when params stay resident
        ospecs = _param_specs(model, cfg, run, run.fsdp)
        distribute_params(model, mesh, pspecs)
        params = dict(model.named_parameters())
        mdt = getattr(torch, run.optimizer.moment_dtype)

        def moments(dt):
            return {n: _place(torch.zeros(p.shape, dtype=dt, device=device),
                              ospecs[n], mesh) for n, p in params.items()}

        # the error-feedback residual shards like the moments
        ef = moments(torch.float32) \
            if uses_error_feedback(run.optimizer.grad_compression) else None
        state = TrainState(params, OptState(0, moments(mdt), moments(mdt)),
                           ef)
        bspecs = batch_specs(inputs, run.mesh, shape, run.parallelism)
        batch = {k: _place(t, bspecs[k], mesh) for k, t in inputs.items()}
        step = build_train_step(model, run)
        state_tree = (state.params, state.opt.m, state.opt.v, state.ef)
        state_bytes = _tree_bytes(state_tree) + _STEP_BYTES
        return Cell(lambda: step(state, batch),
                    _leaves((state_tree, batch)),
                    state_bytes + _tree_bytes(batch), state_bytes)

    pspecs = _param_specs(model, cfg, run, run.fsdp)
    distribute_params(model, mesh, pspecs)
    params = list(model.parameters())
    bspecs = batch_specs(inputs, run.mesh, shape)
    batch = {k: _place(t, bspecs[k], mesh) for k, t in inputs.items()}
    if shape.step == StepKind.PREFILL:
        def prefill():
            with torch.no_grad():
                return model.prefill(batch)

        return Cell(prefill, _leaves((params, batch)),
                    _tree_bytes((params, batch)), 0)

    # decode: one token against a seq_len cache, every position attended
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    cspecs = cache_specs(cache, cfg, run.mesh, shape)
    cache = torch.utils._pytree.tree_map(
        lambda t, s: _place(t, s, mesh), cache, cspecs,
        is_leaf=lambda x: isinstance(x, torch.Tensor))

    def decode():
        with torch.no_grad():
            return model.decode_step(cache, batch["token"], shape.seq_len - 1)

    cache_bytes = _tree_bytes(cache)
    return Cell(decode, _leaves((params, cache, batch)),
                _tree_bytes((params, batch)) + cache_bytes, cache_bytes)


def _zero_fake_calls() -> None:
    for kern, counter in KERNELS.values():
        setattr(kern, counter, 0)


def _fake_calls() -> Dict[str, int]:
    return {name: getattr(kern, counter)
            for name, (kern, counter) in KERNELS.items()}


def trace_cell(cfg: ModelConfig, run: RunConfig, mesh,
               device: Union[str, torch.device] = "cuda",
               memory: bool = True) -> Dict[str, Any]:
    """One step of ``run`` traced on fake tensors on ``mesh``: per-device
    ``flops``, ``collectives`` (a ``CollectiveStats``), ``peak_bytes`` (0
    without ``memory``: the tracker is the costliest counter), the cell's
    ``argument_bytes``, ``output_bytes`` and ``alias_bytes``, and
    ``kernel_calls`` (each kernel's fake calls: the launches the step
    would make)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dp = ("pod", "data", "model") if run.parallelism == "dp_only" else None
    _zero_fake_calls()
    with set_dp_axes(dp), FakeTensorMode():
        cell = build_cell(cfg, run, mesh, device)
        mem = PeakMemory() if memory else contextlib.nullcontext()
        if memory:
            mem.track_external(*cell.arguments)
        flops, coll = DeviceFlops(), CollectiveCounter()
        with mem, flops, coll, use_mesh(mesh):
            out = cell.run()
        if run.shape.step == StepKind.TRAIN:
            state, metrics = out
            out_bytes = (_tree_bytes((state.params, state.opt.m,
                                      state.opt.v, state.ef))
                         + _STEP_BYTES + _tree_bytes(metrics))
        else:
            out_bytes = _tree_bytes(out)
        peak = mem.peak() if memory else 0
    return {"flops": flops.flops, "collectives": coll.stats,
            "peak_bytes": peak, "argument_bytes": cell.argument_bytes,
            "output_bytes": out_bytes, "alias_bytes": cell.alias_bytes,
            "kernel_calls": _fake_calls()}


def _memory(run: RunConfig, t: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's ``memory`` keys from a trace. The trace's peak is
    the device's whole footprint (the in-place state or cache is in the
    arguments once), so ``live_bytes_per_device`` is the peak and
    ``temp_bytes`` what the step adds to its arguments."""
    live = t["peak_bytes"]
    out = {"argument_bytes": t["argument_bytes"],
           "output_bytes": t["output_bytes"],
           "temp_bytes": max(live - t["argument_bytes"], 0),
           "alias_bytes": t["alias_bytes"],
           "live_bytes_per_device": live,
           "fits_v5e_16g": bool(live < TPU_V5E_HBM_GB * 2**30),
           "fits_h100_80g": bool(live < H100_HBM_GB * 2**30)}
    out.update(structural_memory(run, t["argument_bytes"]))
    return out


def _terms(flops: float, bytes_: float, wire: float, machine) -> Dict:
    return {"compute_s": flops / machine.peak_flops,
            "memory_s": bytes_ / machine.hbm_bw,
            "collective_s": wire / machine.ici_bw}


def run_cell(arch: str, shape_name: Union[str, ShapeConfig],
             mesh_cfg: MeshConfig, mesh, mode: str,
             device: Union[str, torch.device] = "cuda",
             **overrides) -> Dict[str, Any]:
    """One cell's record (the reference's keys). ``shape_name`` may be a
    ``ShapeConfig`` (a shape outside the assigned set)."""
    cfg = get_model_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else get_shape(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "mesh": "x".join(map(str, mesh_cfg.shape)),
                           "mode": mode, "status": "ok",
                           "device": str(device)}
    t0 = time.perf_counter()
    try:
        if mode == "compile":
            run = default_run(cfg, shape, mesh_cfg, **overrides)
            t = trace_cell(cfg, run, mesh, device)
            rec["memory"] = _memory(run, t)
            rec["flops"] = float(t["flops"])
            rec["bytes"] = hbm_traffic(run)
            rec["collectives"] = t["collectives"].to_dict()
            rec["kernel_calls"] = t["kernel_calls"]
            # the trace holds every layer and every microbatch
            rec["projection"] = cell_collective_projection(
                cfg, shape, run, t["collectives"],
                dp_reduce_elems=_dp_reduce_elems(cfg, run))
        elif mode == "roofline":
            rec.update(_roofline(cfg, shape, mesh_cfg, mesh, device,
                                 overrides))
        else:
            raise ValueError(f"unknown mode {mode!r}")
    except Exception as e:  # noqa: BLE001 — record, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    return rec


def _roofline(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
              mesh, device, overrides) -> Dict[str, Any]:
    """Bilinear extrapolation over (layer periods k, microbatches m):
    cost(k, m) = C0 + Ck*k + Cm*m + Ckm*k*m, solved from traces at k, m in
    {1, 2}^2 (k only where the cell has one microbatch). Exact for counted
    operations and collectives: per-layer-per-microbatch work (compute,
    ZeRO-3 gathers) in Ckm, per-layer work in Ck, per-microbatch overheads
    in Cm, optimizer, embedding and head in C0."""
    n = _n_periods(cfg)
    full_run = default_run(cfg, shape, mesh_cfg, **dict(overrides))
    n_micro = full_run.microbatches
    points = [(1, 1), (2, 1)]
    if n_micro > 1:
        points += [(1, 2), (2, 2)]
    res = {}
    for k, mcount in points:
        rcfg = _reduced(cfg, k)
        run = default_run(rcfg, shape, mesh_cfg,
                          **dict(overrides, microbatches=mcount))
        res[(k, mcount)] = trace_cell(rcfg, run, mesh, device,
                                      memory=False)

    def extrap(metric) -> float:
        c11, c21 = metric(res[(1, 1)]), metric(res[(2, 1)])
        if n_micro == 1:
            return c11 + (n - 1) * (c21 - c11)
        # exact bilinear: per-microbatch constants (Cm) are not multiplied
        # by depth
        c12, c22 = metric(res[(1, 2)]), metric(res[(2, 2)])
        ckm = c22 - c21 - c12 + c11
        ck = c21 - c11 - ckm
        cm = c12 - c11 - ckm
        c0 = c11 - ck - cm - ckm
        return c0 + ck * n + cm * n_micro + ckm * n * n_micro

    flops = extrap(lambda r: r["flops"])
    kinds = set()
    for r in res.values():
        kinds |= set(r["collectives"].count)
    coll = CollectiveStats()
    for kind in kinds:
        coll.count[kind] = max(int(extrap(
            lambda r: r["collectives"].count.get(kind, 0))), 0)
        coll.buffer_bytes[kind] = max(int(extrap(
            lambda r: r["collectives"].buffer_bytes.get(kind, 0))), 0)
    # the memory term is the analytic traffic model, as in the reference
    bytes_model = hbm_traffic(full_run)
    mf = model_flops(cfg, shape)
    chips = mesh_cfg.num_devices
    rec: Dict[str, Any] = {
        "flops": flops,
        # the reference's XLA-CPU bytes; a fake trace moves none
        "bytes_xla_cpu": None,
        "bytes": bytes_model,
        "collectives": coll.to_dict(),
        "wire_bytes": coll.wire_bytes,
        "kernel_calls": {k: int(extrap(lambda r: r["kernel_calls"][k]))
                         for k in KERNELS},
        "projection": cell_collective_projection(
            cfg, shape, full_run, coll,
            dp_reduce_elems=_dp_reduce_elems(cfg, full_run)),
        "model_flops_total": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_ratio": (mf / chips) / max(flops, 1.0),
    }
    for suffix, machine in (("", TPU_V5E), ("_h100", H100_SXM_BF16)):
        terms = _terms(flops, bytes_model, coll.wire_bytes, machine)
        bound = max(terms.values())
        rec["terms" + suffix] = terms
        rec["dominant" + suffix] = max(terms, key=terms.get)
        rec["roofline_fraction" + suffix] = (
            mf / chips / machine.peak_flops) / max(bound, 1e-12)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="compile",
                    choices=["compile", "roofline"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [SINGLE_POD], "multi": [MULTI_POD],
              "both": [SINGLE_POD, MULTI_POD]}[args.mesh]
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: --device cuda needs a CUDA card; pass "
                         "--device cpu to trace the plain path")

    out_path = args.out or os.path.join(
        RESULTS_DIR, f"dryrun_torch_{args.mode}_{args.mesh}.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    n_fail = 0
    all_recs = []
    with open(out_path, "w") as f:
        for mesh_cfg in meshes:
            with fake_process_group(mesh_cfg.num_devices):
                mesh = make_mesh(mesh_cfg, device.type)
                for arch in archs:
                    cfg = get_model_config(arch)
                    shapes = (shapes_for(cfg) if args.shape == "all"
                              else [get_shape(s)
                                    for s in args.shape.split(",")])
                    for shape in shapes:
                        rec = run_cell(arch, shape.name, mesh_cfg, mesh,
                                       args.mode, device)
                        line = {k: v for k, v in rec.items()
                                if k != "traceback"}
                        print(json.dumps(line), flush=True)
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                        all_recs.append(rec)
                        if rec["status"] != "ok":
                            n_fail += 1

    # per-cell projection-error report: analytic wire bytes vs the
    # collective bytes the trace counted
    report = collective_projection_report(all_recs)
    proj_path = out_path[:-len(".jsonl")] + "_projection.json" \
        if out_path.endswith(".jsonl") else out_path + ".projection.json"
    with open(proj_path, "w") as f:
        json.dump(report, f, indent=1)
    print("\nprojection error (analytic vs measured collective bytes):",
          file=sys.stderr)
    for c in report["cells"]:
        print(f"  {c['cell']:48s} analytic={c['analytic_wire_bytes']:.3e} "
              f"measured={c['measured_wire_bytes']:.3e} "
              f"rel_error={c['rel_error']:.3f} "
              f"claimed={c.get('rel_error_claimed', c['rel_error']):.3f}",
              file=sys.stderr)
    print(f"  max_rel_error={report['max_rel_error']:.3f} "
          f"claimed={report['max_rel_error_claimed']:.3f} "
          f"({report['num_cells']} cells) -> {proj_path}", file=sys.stderr)
    print(f"\n{'FAILURES: ' + str(n_fail) if n_fail else 'ALL CELLS OK'}",
          file=sys.stderr)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
