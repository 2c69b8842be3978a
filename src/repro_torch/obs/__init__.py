"""repro_torch.obs — span tracing, SL-keyed metrics, structured events and
SeqPoint projection-error monitoring.

Copies of ``repro.obs``: trace, metrics (with the live Prometheus scrape
endpoint ``serve_http``), events and projection. Hot paths use the
module-level helpers unconditionally; everything is a no-op until
``enable()`` installs a tracer and an event sink (or the ``REPRO_OBS_DIR``
environment variable does at import).

    from repro_torch import obs

    obs.enable(out_dir="results/obs")
    with obs.span("profile/measure", sl=128):
        ...
    obs.metrics.histogram("profile_step_time_s", sl=128).observe(dt)
    obs.event("seqpoints_selected", num_points=7)
    obs.export_all()        # trace.json + metrics.json/.prom + events flush
"""
from __future__ import annotations

import atexit
import os
from typing import Dict, Optional

from repro_torch.obs.events import (
    DEFAULT_EVENTS_PATH,
    EventSink,
    event,
    get_sink,
    set_sink,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsServer,
    bucket_bound,
    get_registry,
    metrics,
    serve_http,
)
from repro_torch.obs.projection import (
    ProjectionMonitor,
    ProjectionReport,
    SLResidual,
    analytic_wire_bytes,
    cell_collective_projection,
    collective_projection_report,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    Tracer,
    enable_tracing,
    get_tracer,
    set_tracer,
    span,
    traced,
    tracing_enabled,
)

__all__ = [
    "Counter", "DEFAULT_EVENTS_PATH", "EventSink", "Gauge", "Histogram",
    "MetricsRegistry", "MetricsServer", "NULL_SPAN", "ProjectionMonitor",
    "ProjectionReport", "SLResidual", "Tracer", "analytic_wire_bytes",
    "cell_collective_projection", "collective_projection_report",
    "bucket_bound", "disable", "enable", "enable_tracing", "event",
    "export_all", "get_registry", "get_sink", "get_tracer", "metrics",
    "serve_http", "set_sink", "set_tracer", "span", "traced",
    "tracing_enabled",
]

_OUT_DIR: Optional[str] = None
_ATEXIT_REGISTERED = False


def _export_at_exit() -> None:
    if _OUT_DIR is not None and tracing_enabled():
        try:
            export_all()
        except Exception:       # noqa: BLE001 — never fail the interpreter
            pass


def enable(*, trace: bool = True, out_dir: Optional[str] = None,
           events_path: Optional[str] = None,
           flush_every: int = 32) -> None:
    """Turn the layer on: tracing + a JSONL event sink. ``out_dir`` anchors
    ``export_all()`` and defaults the events path to
    ``<out_dir>/events.jsonl``. With an ``out_dir``, artifacts also export
    automatically at interpreter exit, so ``REPRO_OBS_DIR`` works for any
    entry point without an explicit ``export_all()`` call."""
    global _OUT_DIR, _ATEXIT_REGISTERED
    _OUT_DIR = out_dir
    enable_tracing(trace)
    if events_path is None and out_dir is not None:
        events_path = os.path.join(out_dir, "events.jsonl")
    prev = set_sink(EventSink(events_path, flush_every=flush_every))
    if prev is not None:
        prev.close()
    if out_dir is not None and not _ATEXIT_REGISTERED:
        atexit.register(_export_at_exit)
        _ATEXIT_REGISTERED = True


def disable() -> None:
    """Back to zero-cost: tracing off, event sink closed and removed."""
    enable_tracing(False)
    prev = set_sink(None)
    if prev is not None:
        prev.close()


def export_all(out_dir: Optional[str] = None) -> Dict[str, str]:
    """Write trace.json (Chrome/Perfetto), metrics.json, metrics.prom and
    flush the event sink; returns the paths written."""
    out_dir = out_dir or _OUT_DIR or os.path.dirname(DEFAULT_EVENTS_PATH)
    os.makedirs(out_dir, exist_ok=True)
    paths: Dict[str, str] = {}
    paths["trace"] = get_tracer().export_chrome_trace(
        os.path.join(out_dir, "trace.json"))
    mpath = os.path.join(out_dir, "metrics.json")
    with open(mpath, "w") as f:
        f.write(metrics.to_json(indent=1))
    paths["metrics_json"] = mpath
    ppath = os.path.join(out_dir, "metrics.prom")
    with open(ppath, "w") as f:
        f.write(metrics.to_prometheus())
    paths["metrics_prom"] = ppath
    sink = get_sink()
    if sink is not None:
        sink.flush()
        paths["events"] = sink.path
    return paths


# opt-in via environment: REPRO_OBS_DIR=<dir> enables tracing + events for
# any entry point without code changes
_env_dir = os.environ.get("REPRO_OBS_DIR")
if _env_dir:
    enable(out_dir=_env_dir)
