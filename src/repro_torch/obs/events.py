"""Structured JSONL event sink: run metadata, per-step records, stragglers,
checkpoint saves.

One event = one JSON object on one line, stamped with wallclock time and a
monotonically increasing sequence number, so downstream tooling (DeepProf
2017-style trace mining, or plain jq) can join events against the span
trace. Events buffer in memory and flush every ``flush_every`` emits (and on
``close``/interpreter exit); ``max_bytes`` rotates the file to ``<path>.1``
so long runs cannot fill a disk.

When no sink is installed the module-level ``event(...)`` is a single
``is None`` check — hot paths can emit unconditionally.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_REPO_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
DEFAULT_EVENTS_PATH = os.path.abspath(
    os.path.join(_REPO_ROOT, "results", "events.jsonl"))


class EventSink:
    def __init__(self, path: Optional[str] = None, *,
                 flush_every: int = 32,
                 max_bytes: Optional[int] = None):
        self.path = os.path.abspath(path or DEFAULT_EVENTS_PATH)
        self.flush_every = max(1, int(flush_every))
        self.max_bytes = max_bytes
        self._buf: List[str] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._file = None
        self._closed = False
        atexit.register(self.close)

    # ------------------------------------------------------------------
    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._buf.append(json.dumps(rec, default=_jsonable))
            if len(self._buf) >= self.flush_every:
                self._flush_locked()
        return rec

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None
            self._closed = True

    # ------------------------------------------------------------------
    def _open_locked(self):
        if self._file is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._file = open(self.path, "a")
            self._closed = False
        return self._file

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        data = "\n".join(self._buf) + "\n"
        self._buf.clear()
        f = self._open_locked()
        # rotate BEFORE writing so the live file always exists afterwards
        if self.max_bytes is not None and f.tell() \
                and f.tell() + len(data) > self.max_bytes:
            f.close()
            os.replace(self.path, self.path + ".1")
            self._file = None
            f = self._open_locked()
        f.write(data)
        f.flush()

    def __enter__(self) -> "EventSink":
        return self

    def __exit__(self, *exc: object) -> bool:
        self.close()
        return False


def _jsonable(o: Any) -> Any:
    for cast in (float, str):
        try:
            return cast(o)
        except Exception:       # noqa: BLE001 — best effort serialization
            continue
    return repr(o)


# --------------------------------------------------------------------------
# process-global sink (absent by default: event() is then a no-op)

_SINK: Optional[EventSink] = None


def set_sink(sink: Optional[EventSink]) -> Optional[EventSink]:
    """Install (or remove, with None) the global sink; returns the old one."""
    global _SINK
    prev, _SINK = _SINK, sink
    return prev


def get_sink() -> Optional[EventSink]:
    return _SINK


def event(kind: str, **fields: Any) -> Optional[Dict[str, Any]]:
    sink = _SINK
    if sink is None:
        return None
    return sink.emit(kind, **fields)
