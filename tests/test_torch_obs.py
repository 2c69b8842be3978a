"""The port's copy of the observability layer against ``repro.obs``: the
same observations give the same exports."""
import importlib
import json

from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.obs import trace as ttrace

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
