"""Process-wide metrics registry: counters, gauges, log2-bucketed histograms.

Everything SeqPoint cares about is keyed by sequence length, so metrics take
free-form label kwargs (``histogram("train_step_time_s", sl=128)``) and the
histogram buckets are powers of two — the same log-scale geometry as padded
SLs themselves. A value ``v`` lands in the bucket whose upper bound is the
smallest power of two ``>= v`` (exact powers of two land on their own
bound), so bucket edges are stable across runs and merges are trivial.

Export: ``snapshot()`` (plain dicts, JSON-ready) and ``to_prometheus()``
(text exposition format with cumulative ``_bucket{le=...}`` lines), which
``serve_http`` serves live at ``/metrics``.
Mutation ops are single dict/float updates under the GIL; registry creation
is locked.
"""
from __future__ import annotations

import json
import math
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, n: float = 1.0) -> None:
        self.value += n


def bucket_bound(v: float) -> float:
    """Smallest power of two >= v (the bucket's ``le`` bound); 0 for v<=0."""
    if v <= 0.0:
        return 0.0
    return float(2.0 ** math.ceil(math.log2(v)))


class Histogram:
    """Sparse log2-bucketed histogram with sum/count/min/max."""

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.buckets: Dict[float, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        b = bucket_bound(v)
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def cumulative(self) -> List[Tuple[float, int]]:
        """(le, cumulative count) pairs in ascending bound order."""
        out, acc = [], 0
        for b in sorted(self.buckets):
            acc += self.buckets[b]
            out.append((b, acc))
        return out


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> (type_name, {label_key: metric})
        self._metrics: Dict[str, Tuple[str, Dict[LabelKey, Any]]] = {}

    def _get(self, type_name: str, name: str, labels: Dict[str, Any]):
        key = _label_key(labels)
        entry = self._metrics.get(name)
        if entry is not None and key in entry[1]:
            if entry[0] != type_name:
                raise TypeError(f"metric {name!r} is a {entry[0]}, "
                                f"not a {type_name}")
            return entry[1][key]
        with self._lock:
            entry = self._metrics.setdefault(name, (type_name, {}))
            if entry[0] != type_name:
                raise TypeError(f"metric {name!r} is a {entry[0]}, "
                                f"not a {type_name}")
            return entry[1].setdefault(key, _TYPES[type_name]())

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get("histogram", name, labels)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export ---------------------------------------------------------
    def snapshot(self) -> Dict[str, List[Dict[str, Any]]]:
        """JSON-ready view: name -> list of {type, labels, ...} series."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        with self._lock:
            items = {n: (t, dict(series))
                     for n, (t, series) in self._metrics.items()}
        for name, (type_name, series) in sorted(items.items()):
            rows = []
            for key, m in sorted(series.items()):
                row: Dict[str, Any] = {"type": type_name,
                                       "labels": dict(key)}
                if type_name in ("counter", "gauge"):
                    row["value"] = m.value
                else:
                    row.update(count=m.count, sum=m.sum, mean=m.mean,
                               min=m.min if m.count else None,
                               max=m.max if m.count else None,
                               buckets={str(b): c for b, c
                                        in sorted(m.buckets.items())})
                rows.append(row)
            out[name] = rows
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        lines: List[str] = []
        snap_src: Dict[str, Tuple[str, Dict[LabelKey, Any]]]
        with self._lock:
            snap_src = {n: (t, dict(series))
                        for n, (t, series) in self._metrics.items()}
        for name, (type_name, series) in sorted(snap_src.items()):
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {type_name}")
            for key, m in sorted(series.items()):
                lbl = _prom_labels(key)
                if type_name in ("counter", "gauge"):
                    lines.append(f"{pname}{lbl} {_fmt(m.value)}")
                    continue
                for le, cum in m.cumulative():
                    lines.append(f"{pname}_bucket"
                                 f"{_prom_labels(key, le=_fmt(le))} {cum}")
                lines.append(f"{pname}_bucket"
                             f"{_prom_labels(key, le='+Inf')} {m.count}")
                lines.append(f"{pname}_sum{lbl} {_fmt(m.sum)}")
                lines.append(f"{pname}_count{lbl} {m.count}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() and abs(v) < 1e15 \
        else repr(float(v))


def _prom_labels(key: LabelKey, **extra: str) -> str:
    pairs = list(key) + sorted(extra.items())
    if not pairs:
        return ""
    body = ",".join(f'{_prom_name(k)}="{v}"' for k, v in pairs)
    return "{" + body + "}"


# --------------------------------------------------------------------------
# process-global registry

metrics = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return metrics


# --------------------------------------------------------------------------
# live Prometheus scrape endpoint (closes the snapshot-at-exit gap: metrics
# were only visible after the run via export_all; a scraper can now watch a
# training or serving run in flight)


class MetricsServer:
    """Handle for a running scrape endpoint: ``.port``, ``.url``,
    ``.close()``. Context-manager friendly."""

    def __init__(self, httpd, thread):
        self._httpd = httpd
        self._thread = thread
        self.addr, self.port = httpd.server_address[:2]

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_http(port: int = 0, addr: str = "127.0.0.1",
               registry: Optional[MetricsRegistry] = None) -> MetricsServer:
    """Start a background-thread HTTP server exposing the registry in
    Prometheus text format at ``/metrics`` (and ``/`` as a pointer).

    Stdlib-only (``http.server``); every scrape renders a fresh
    ``to_prometheus()`` so the numbers are live, not snapshot-at-exit.
    ``port=0`` binds an ephemeral port (see the returned handle's
    ``.port``). The serving thread is a daemon: it never blocks
    interpreter exit, but call ``.close()`` for a clean shutdown.
    """
    import http.server

    reg = registry or metrics

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):                            # noqa: N802 (stdlib)
            if self.path.rstrip("/") in ("", "/index.html"):
                body = b"repro_torch.obs metrics: scrape /metrics\n"
                ctype = "text/plain; charset=utf-8"
            elif self.path.startswith("/metrics"):
                body = reg.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):                # keep scrapes silent
            pass

    httpd = http.server.ThreadingHTTPServer((addr, port), Handler)
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever,
                         name="repro-torch-obs-metrics-http", daemon=True)
    t.start()
    return MetricsServer(httpd, t)
