"""Lightweight span tracer with Chrome-trace-event export.

SeqPoint's premise is that detailed profiling is too expensive to run on
every iteration (paper §I) — so the tracer must cost nothing when it is off
and almost nothing when it is on. Disabled, ``span()`` returns one shared
no-op context manager: no clock read, no allocation, no lock. Enabled, each
span is a single perf_counter pair plus one dict appended under a lock.

Spans nest via a thread-local stack, so concurrent threads (e.g. the async
checkpoint writer) interleave correctly in the exported trace. Export is the
Chrome trace-event JSON format (``{"traceEvents": [...]}``, "X" complete
events with microsecond timestamps) — drop the file into Perfetto
(https://ui.perfetto.dev) or chrome://tracing and the nesting renders as a
flame graph per thread.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class _NullSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, **args: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.depth = 0

    def set(self, **args: Any) -> "_Span":
        """Attach attributes after entry (e.g. a result computed inside)."""
        self.args.update(args)
        return self

    def __enter__(self) -> "_Span":
        stack = self.tracer._stack()
        self.depth = len(stack)
        stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        t1 = time.perf_counter()
        self.tracer._stack().pop()
        self.tracer._record(self, t1)
        return False


class Tracer:
    """Collects spans as Chrome trace events; thread-safe."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch = time.perf_counter()

    # -- recording ------------------------------------------------------
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, sp: _Span, t1: float) -> None:
        ev = {
            "name": sp.name,
            "ph": "X",
            "ts": (sp.t0 - self._epoch) * 1e6,      # microseconds
            "dur": (t1 - sp.t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if sp.args or sp.depth:
            ev["args"] = dict(sp.args, depth=sp.depth)
        with self._lock:
            self.events.append(ev)

    def span(self, name: str, **args: Any):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def current_span(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1] if stack else None

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    # -- export ---------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# --------------------------------------------------------------------------
# process-global tracer (disabled by default: zero-cost in production paths)

_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the global tracer (tests); returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def enable_tracing(on: bool = True) -> None:
    _TRACER.enabled = on


def tracing_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **args: Any):
    """``with span("train/step", sl=128): ...`` on the global tracer."""
    tracer = _TRACER
    if not tracer.enabled:
        return NULL_SPAN
    return _Span(tracer, name, args)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form: ``@traced()`` wraps the call in a span."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a: Any, **kw: Any):
            with span(label):
                return fn(*a, **kw)

        return wrapper

    return deco
