"""The port's copy of the observability layer against ``repro.obs``: the
same observations give the same exports, the same projection reports and
analytic wire bytes, and the same live scrape; ``REPRO_OBS_DIR`` exports
at interpreter exit."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import pytest

from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.obs import trace as ttrace

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# each package's obs/__init__ exports a registry named ``metrics``
jmetrics = importlib.import_module("repro.obs.metrics")
tmetrics = importlib.import_module("repro_torch.obs.metrics")


def _observe(reg):
    for sl, dt in ((16, 0.01), (16, 0.03), (128, 0.5), (128, 1.0)):
        reg.histogram("profile_step_time_s", sl=sl).observe(dt)
    reg.counter("profile_cache_hits_total", provider="wallclock").inc(3)
    reg.gauge("queue_depth").set(7)


def test_metrics_exports_match():
    regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
    for reg in regs:
        _observe(reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].to_prometheus() == regs[1].to_prometheus()


def test_trace_nesting_matches():
    events = []
    for mod in (jtrace, ttrace):
        tracer = mod.Tracer(enabled=True)
        with tracer.span("profile/wallclock", sl=8):
            with tracer.span("profile/measure", sl=8):
                pass
        events.append([(e["name"], e["args"]) for e in
                       tracer.to_chrome_trace()["traceEvents"]
                       if e.get("ph") == "X"])
    assert events[0] == events[1]
    assert {name for name, _ in events[1]} == {"profile/wallclock",
                                               "profile/measure"}


def test_enable_export_disable(tmp_path):
    obs.enable(out_dir=str(tmp_path))
    try:
        with obs.span("quickstart/profile_epoch"):
            obs.event("run_start", network="gnmt")
        paths = obs.export_all()
    finally:
        obs.disable()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e["name"] == "quickstart/profile_epoch"
               for e in trace["traceEvents"])
    assert "run_start" in (tmp_path / "events.jsonl").read_text()
    assert set(paths) == {"trace", "metrics_json", "metrics_prom", "events"}
    assert obs.span("after") is ttrace.NULL_SPAN


# ---------------------------------------------------------------------------
# the projection monitor, the collective projection and the scrape endpoint,
# mirroring tests/test_obs.py and held to the reference's numbers


def _synthetic_log(log_cls, scale=1.0):
    log = log_cls()
    for sl, rt, n in ((16, 0.1, 30), (32, 0.2, 20), (64, 0.4, 10)):
        for _ in range(n):
            log.append(sl, rt * scale)
    return log


def _monitors(scale):
    from repro import obs as jobs
    from repro.core.profile import EpochLog as JLog
    from repro.core.seqpoint import select_seqpoints as jselect
    from repro_torch.core.profile import EpochLog as TLog
    from repro_torch.core.seqpoint import select_seqpoints as tselect

    out = []
    for o, log_cls, select in ((jobs, JLog, jselect), (obs, TLog, tselect)):
        sp = select(_synthetic_log(log_cls))
        mon = o.ProjectionMonitor(sp)
        mon.observe_log(_synthetic_log(log_cls, scale))
        out.append((sp, mon.report()))
    return out


def test_projection_monitor_exact_on_selection_log():
    (jsp, jrep), (sp, rep) = _monitors(1.0)
    assert rep.iterations == 60
    assert rep.rel_error < 1e-9
    assert rep.eq1_predicted == pytest.approx(sp.predicted)
    assert len(rep.per_sl) == 3
    for r in rep.per_sl:
        assert abs(r.residual) < 1e-12
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)


def test_projection_monitor_detects_drift():
    (_, jrep), (_, rep) = _monitors(1.25)       # hardware 25% slower
    assert rep.rel_error == pytest.approx(0.2, abs=1e-6)
    worst = rep.worst_sl()
    assert worst is not None and worst.residual > 0
    for r in rep.per_sl:
        assert r.measured_mean == pytest.approx(r.predicted * 1.25)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert dataclasses.asdict(worst) == dataclasses.asdict(jrep.worst_sl())


def test_collective_projection_report_aggregates():
    from repro.obs.projection import collective_projection_report as jrep

    records = [
        {"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok",
         "projection": {"rel_error": 0.1, "analytic_wire_bytes": 1.0,
                        "measured_wire_bytes": 1.1}},
        {"arch": "b", "shape": "s", "mesh": "16x16", "status": "error"},
        {"arch": "c", "shape": "s", "mesh": "16x16", "status": "ok",
         "projection": {"rel_error": 0.4, "analytic_wire_bytes": 2.0,
                        "measured_wire_bytes": 1.2}},
    ]
    rep = obs.collective_projection_report(records, error_bound=0.5)
    assert rep["num_cells"] == 2
    assert rep["max_rel_error"] == pytest.approx(0.4)
    assert rep["within_bound"] is True
    assert not obs.collective_projection_report(
        records, error_bound=0.2)["within_bound"]
    for bound in (None, 0.2, 0.5):
        assert obs.collective_projection_report(records, error_bound=bound) \
            == jrep(records, error_bound=bound)


def test_analytic_wire_bytes_decode_uses_single_token():
    from repro import configs as jc
    from repro.obs.projection import analytic_wire_bytes as jwire
    from repro_torch import configs as tc
    from repro_torch.dist.sharding import tp_activation_wire_bytes

    cfg = tc.get_model_config("starcoder2-3b")
    decode = tc.get_shape("decode_32k")
    a = obs.analytic_wire_bytes(cfg, decode, parallelism="tp", dp_degree=16,
                                tp_degree=16)
    assert a["dp_grad"] == 0.0
    expected = tp_activation_wire_bytes(cfg, decode.global_batch, 1, 16,
                                        training=False)
    assert a["tp_activation"] == pytest.approx(expected)
    assert a["tp_activation"] > 0
    assert a["total"] == pytest.approx(a["tp_activation"])
    assert a == jwire(jc.get_model_config("starcoder2-3b"),
                      jc.get_shape("decode_32k"), parallelism="tp",
                      dp_degree=16, tp_degree=16)


@pytest.mark.parametrize("kw", [dict(), dict(grad_dtype_bytes=2.0),
                                dict(micro_reduces=4),
                                dict(grad_compression="int8_ef"),
                                dict(dp_reduce_elems=1e9)])
def test_analytic_wire_bytes_grad_dtype_and_micro_reduces(kw):
    from repro import configs as jc
    from repro.obs.projection import analytic_wire_bytes as jwire
    from repro_torch import configs as tc

    cfg = tc.get_model_config("starcoder2-3b")
    train = tc.get_shape("train_4k")
    base = obs.analytic_wire_bytes(cfg, train, parallelism="tp",
                                   dp_degree=4, tp_degree=4)
    got = obs.analytic_wire_bytes(cfg, train, parallelism="tp",
                                  dp_degree=4, tp_degree=4, **kw)
    if kw.get("grad_dtype_bytes") == 2.0:
        assert got["dp_grad"] == pytest.approx(base["dp_grad"] / 2)
        assert got["tp_activation"] == pytest.approx(base["tp_activation"])
    if kw.get("micro_reduces") == 4:
        assert got["dp_grad"] == pytest.approx(4 * base["dp_grad"])
    assert got == jwire(jc.get_model_config("starcoder2-3b"),
                        jc.get_shape("train_4k"), parallelism="tp",
                        dp_degree=4, tp_degree=4, **kw)


def test_cell_projection_micro_counted_normalizes_rolled_scan():
    from repro import configs as jc
    from repro.obs.projection import cell_collective_projection as jcell
    from repro.perfmodel.hlo import CollectiveStats as JStats
    from repro_torch import configs as tc
    from repro_torch.perfmodel.hlo import CollectiveStats

    def run_of(c):
        return c.RunConfig(model=c.get_model_config("starcoder2-3b"),
                           shape=c.get_shape("train_4k"),
                           mesh=c.MeshConfig(shape=(4, 4),
                                             axes=("data", "model")),
                           fsdp=True, microbatches=4)

    run, jrun = run_of(tc), run_of(jc)
    assert run.zero_stage >= 3 and run.compute_dtype == "bfloat16"
    stats = []
    for cls in (CollectiveStats, JStats):
        m = cls()
        m.count["all-reduce"] = 1
        m.buffer_bytes["all-reduce"] = 10**9
        m.count["all-gather"] = 4
        m.buffer_bytes["all-gather"] = 10**9
        stats.append(m)
    measured, jmeasured = stats
    assert measured.wire_bytes == jmeasured.wire_bytes == 3 * 10**9
    assert measured.to_dict() == jmeasured.to_dict()
    assert CollectiveStats.from_dict(measured.to_dict()).plus(
        measured).minus(measured).scaled(2.0).to_dict() == \
        JStats.from_dict(jmeasured.to_dict()).plus(jmeasured).minus(
            jmeasured).scaled(2.0).to_dict()
    rolled = obs.cell_collective_projection(run.model, run.shape, run,
                                            measured, micro_counted=1)
    full = obs.cell_collective_projection(run.model, run.shape, run,
                                          measured)
    assert rolled["micro_reduces"] == 4 and rolled["micro_counted"] == 1
    assert full["micro_counted"] == 4
    assert full["analytic_dp_bytes"] == \
        pytest.approx(4 * rolled["analytic_dp_bytes"])
    assert rolled["grad_dtype_bytes"] == 2.0
    assert rolled["measured_claimed_wire_bytes"] < \
        rolled["measured_reduce_wire_bytes"] <= rolled["measured_wire_bytes"]
    for kw in (dict(micro_counted=1), dict(), dict(layers_counted=2,
                                                  dp_reduce_elems=1e8)):
        assert obs.cell_collective_projection(
            run.model, run.shape, run, measured, **kw) == \
            jcell(jrun.model, jrun.shape, jrun, jmeasured, **kw)


def test_serve_http_scrapes_live_metrics():
    """The background endpoint renders a fresh to_prometheus() per scrape
    and shuts down cleanly."""
    import urllib.request

    reg = tmetrics.MetricsRegistry()
    reg.counter("scrape_demo_total", sl=64).inc(2)
    with obs.serve_http(registry=reg) as srv:
        assert srv.port > 0
        body = urllib.request.urlopen(srv.url, timeout=5).read().decode()
        assert '# TYPE scrape_demo_total counter' in body
        assert 'scrape_demo_total{sl="64"} 2' in body
        reg.counter("scrape_demo_total", sl=64).inc()
        body = urllib.request.urlopen(srv.url, timeout=5).read().decode()
        assert 'scrape_demo_total{sl="64"} 3' in body
        idx = urllib.request.urlopen(
            f"http://{srv.addr}:{srv.port}/", timeout=5).read().decode()
        assert "/metrics" in idx
        with pytest.raises(Exception):
            urllib.request.urlopen(
                f"http://{srv.addr}:{srv.port}/nope", timeout=5)


def test_repro_obs_dir_exports_at_exit(tmp_path):
    """``REPRO_OBS_DIR`` turns the layer on at import and the artifacts
    are written when the interpreter exits, with no ``export_all()``."""
    out = tmp_path / "obs"
    code = ("from repro_torch import obs\n"
            "with obs.span('probe/span'):\n"
            "    obs.event('probe_event', n=1)\n"
            "obs.metrics.counter('probe_total').inc()\n"
            "import sys\n"
            "print('jax' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["REPRO_OBS_DIR"] = str(out)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    trace = json.loads((out / "trace.json").read_text())
    assert any(e["name"] == "probe/span" for e in trace["traceEvents"])
    assert "probe_event" in (out / "events.jsonl").read_text()
    assert "probe_total" in (out / "metrics.prom").read_text()
    assert res.stdout.split() == ["False"]
