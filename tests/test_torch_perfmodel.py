"""The port's analytic performance models against the JAX package's, on the
CPU: ``param_count`` and ``model_flops`` for every arch and shape,
``hbm_traffic`` and ``structural_memory`` for every arch x shape x
{SINGLE_POD, MULTI_POD} x each ``launch/perf.py`` option set, and the dry
run's ``default_run`` field by field. All are pure Python on the configs,
so every number must be equal (tolerance 0).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; the import below sets the variable to its present value first,
so that its ``setdefault`` does nothing and later JAX tests (and their
subprocesses) keep the worker's device count.
"""
import dataclasses
import enum
import os

import pytest

from repro.configs import (
    MULTI_POD as J_MULTI,
    SINGLE_POD as J_SINGLE,
    get_model_config as j_cfg,
    list_archs,
    shapes_for as j_shapes_for,
)
from repro.perfmodel import memory as jmem
from repro.perfmodel import model_flops as jmf
from repro.perfmodel import traffic as jtr

from repro_torch.configs import MULTI_POD, SINGLE_POD, get_model_config
from repro_torch.configs import shapes_for
from repro_torch.launch.perf import OPTS
from repro_torch.perfmodel import machine, memory, model_flops, traffic

MESHES = {"single": (SINGLE_POD, J_SINGLE), "multi": (MULTI_POD, J_MULTI)}
OPT_SETS = {"baseline": {}, **OPTS}
ARGUMENT_BYTES = 3 * 10**9 + 7          # any number: both add it the same


@pytest.fixture
def jdryrun(monkeypatch):
    """The reference's ``repro.launch.dryrun``, imported without changing
    the worker's ``XLA_FLAGS``."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun

    return dryrun


def _plain(x):
    """A config as plain data (dataclasses, enums and tuples unwrapped), so
    the two packages' configs compare field by field."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("arch", list_archs())
def test_param_count_and_model_flops_match(arch):
    cfg, jcfg = get_model_config(arch), j_cfg(arch)
    for active in (False, True):
        assert model_flops.param_count(cfg, active) \
            == jmf.param_count(jcfg, active)
    shapes = shapes_for(cfg)
    assert [s.name for s in shapes] == [s.name for s in j_shapes_for(jcfg)]
    for shape, jshape in zip(shapes, j_shapes_for(jcfg)):
        assert model_flops.model_flops(cfg, shape) \
            == jmf.model_flops(jcfg, jshape)


@pytest.mark.parametrize("arch", list_archs())
def test_default_run_traffic_and_memory_match(arch, jdryrun):
    from repro_torch.launch.dryrun import default_run

    cfg, jcfg = get_model_config(arch), j_cfg(arch)
    n = 0
    for shape, jshape in zip(shapes_for(cfg), j_shapes_for(jcfg)):
        for mesh, jmesh in MESHES.values():
            for opt in OPT_SETS.values():
                run = default_run(cfg, shape, mesh, **dict(opt))
                jrun = jdryrun.default_run(jcfg, jshape, jmesh, **dict(opt))
                assert _plain(run) == _plain(jrun), (shape.name, opt)
                assert traffic.hbm_traffic(run) == jtr.hbm_traffic(jrun)
                assert memory.structural_memory(run, ARGUMENT_BYTES) \
                    == jmem.structural_memory(jrun, ARGUMENT_BYTES)
                n += 1
    assert n == len(shapes_for(cfg)) * len(MESHES) * len(OPT_SETS)


def test_reduced_and_period_counts_match(jdryrun):
    from repro_torch.launch.dryrun import _n_periods, _reduced

    for arch in list_archs():
        cfg, jcfg = get_model_config(arch), j_cfg(arch)
        assert _n_periods(cfg) == jdryrun._n_periods(jcfg)
        for k in (1, 2):
            assert _plain(_reduced(cfg, k)) == _plain(jdryrun._reduced(jcfg,
                                                                       k))


def test_machine_constants_match_the_reference():
    from repro.perfmodel import machine as jmachine

    assert dataclasses.asdict(machine.TPU_V5E) \
        == dataclasses.asdict(jmachine.TPU_V5E)
    assert machine.TPU_V5E_HBM_GB == jmachine.TPU_V5E_HBM_GB
    h = machine.H100_SXM_BF16
    assert (h.peak_flops, h.hbm_bw, h.ici_bw) \
        == (989e12, 3.35e12, machine.H100_SXM.ici_bw)
