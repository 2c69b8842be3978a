"""Fault-tolerant checkpointing: atomic, versioned, async (a port of
``repro.ckpt.checkpoint``).

Layout:  <dir>/step_<N>/
            manifest.json   — step, flat leaf paths, shapes/dtypes, the
                              sha256 of arrays.npz, the caller's ``extra``
                              (data-iterator state, partial EpochLog, ...)
            arrays.npz      — flat {path: np.ndarray} (host copies)

A state is a tree of dicts, lists, tuples and dataclasses whose leaves are
tensors, numpy arrays or Python numbers; ``None`` leaves vanish. Paths join
dict keys, field names and list indices with ``/``. numpy has no bfloat16,
so a bf16 tensor is stored as its raw bits (``uint16``) and the manifest
records ``"bfloat16"``; restore gives back the same bits.

Writes go to ``step_<N>.tmp`` and are renamed only after fsync — a killed
writer never corrupts the latest checkpoint. ``keep_last`` prunes old steps.
``save_async`` copies every leaf to host memory before it returns (the next
optimizer step writes the parameters in place) and writes on a background
thread so the train loop continues.

Restore is *defensive*: the manifest's recorded sha256 of ``arrays.npz`` is
verified before anything is loaded, and a corrupt or truncated step falls
back to the previous ``step_<N>`` instead of killing the resume
(structural mismatches — wrong shapes, missing leaves — still raise,
because an older checkpoint would not fix those). Background-write failures
are captured and re-raised at the next ``wait()``/``save()``/
``save_async()`` rather than silently discovered at restore time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.resilience import faults

# errors that mean "this step's files are damaged" — safe to fall back past
# (injected TransientFault is deliberately NOT here: transient I/O should be
# retried on the same step by the caller, not skipped to an older state)
_DAMAGE = (IOError, OSError, EOFError, zipfile.BadZipFile,
           json.JSONDecodeError)

Tree = Any


def _children(tree: Tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree: Tree, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            yield prefix, tree
        return
    for k, v in kids:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else k)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory and the dtype name to record."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.array(leaf)
    return a, str(a.dtype)


def _flatten(tree: Tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        flat[key], dtypes[key] = _to_host(leaf)
    return flat, dtypes


def _from_host(arr: np.ndarray, dtype: str, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(like.device)
    if isinstance(like, np.ndarray):
        return arr
    return type(like)(arr.item())


def _rebuild(tree: Tree, prefix: str, get) -> Tree:
    kids = _children(tree)
    if kids is None:
        return None if tree is None else get(prefix, tree)
    new = {k: _rebuild(v, f"{prefix}/{k}" if prefix else k, get)
           for k, v in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **new)
    if hasattr(tree, "_fields"):
        return type(tree)(**new)
    return type(tree)(new[str(i)] for i in range(len(tree)))


def _unflatten_like(tree: Tree, flat: Dict[str, np.ndarray],
                    dtypes: Dict[str, str]) -> Tree:
    def get(key: str, leaf: Any) -> Any:
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(np.shape(leaf))}")
        return _from_host(arr, dtypes[key], leaf)
    return _rebuild(tree, "", get)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                manifest = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(manifest):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Tree, *,
             extra: Optional[dict] = None) -> str:
        self.wait()             # surface any pending background-write error
        return self._write(step, *_flatten(state), extra or {})

    def save_async(self, step: int, state: Tree, *,
                   extra: Optional[dict] = None) -> None:
        """Snapshot synchronously (device -> host copies), write in the
        background.

        A failing background write is captured and re-raised at the next
        ``wait()``/``save()``/``save_async()`` (plus an immediate obs
        event), so a dying checkpoint disk shows up within one save
        interval, not at restore time.
        """
        self.wait()
        flat, dtypes = _flatten(state)               # blocking copy to host

        def work():
            try:
                self._write(step, flat, dtypes, extra or {})
            except BaseException as e:                 # noqa: BLE001
                self._error = e
                obs.metrics.counter("ckpt_async_errors_total").inc()
                obs.event("ckpt_async_error", step=step, error=repr(e))

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               dtypes: Dict[str, str], extra: dict) -> str:
        faults.fire("ckpt_save", step)
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **flat)
        with open(npz_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if faults.check("ckpt_corrupt", step) is not None:
            # silent media corruption: damage the shard AFTER the digest is
            # recorded, so only restore-time verification can catch it
            with open(npz_path, "r+b") as f:
                f.seek(min(64, os.path.getsize(npz_path) - 4))
                f.write(b"\xde\xad\xbe\xef")
        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
            "sha256": digest,
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()
        return final

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def verify_step(self, step: int) -> bool:
        """True iff ``step``'s shard matches its manifest-recorded sha256."""
        try:
            d = self._step_dir(step)
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            with open(os.path.join(d, "arrays.npz"), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            return digest == manifest["sha256"]
        except _DAMAGE:
            return False

    def restore(self, like: Tree, step: Optional[int] = None, *,
                verify: bool = True,
                fallback: Optional[bool] = None) -> Tuple[Tree, dict]:
        """Load into the structure of ``like``: a new tree whose tensor
        leaves sit on the device of ``like``'s and keep the saved dtype.

        The shard sha256 is verified against the manifest before loading.
        With ``fallback`` (default: on when ``step`` is not pinned), a
        corrupt/truncated step is skipped and the previous ``step_<N>`` is
        tried, newest first; ``IOError`` only if none is usable.
        """
        faults.fire("ckpt_restore", -1 if step is None else step)
        steps = self.steps()
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            fallback = True if fallback is None else fallback
            candidates = list(reversed(steps))
        else:
            fallback = False if fallback is None else fallback
            candidates = [step] + [s for s in reversed(steps) if s < step]
        if not fallback:
            candidates = candidates[:1]
        last_err: Optional[BaseException] = None
        for s in candidates:
            try:
                return self._restore_step(s, like, verify=verify)
            except _DAMAGE as e:
                last_err = e
                obs.metrics.counter("ckpt_fallback_total").inc()
                obs.event("ckpt_restore_failed", step=s, error=repr(e),
                          will_fallback=s != candidates[-1])
                continue
        raise IOError(f"no usable checkpoint in {self.dir} "
                      f"(tried {candidates}): {last_err!r}")

    def _restore_step(self, step: int, like: Tree, *,
                      verify: bool) -> Tuple[Tree, dict]:
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        npz_path = os.path.join(d, "arrays.npz")
        if verify:
            with open(npz_path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != manifest["sha256"]:
                raise IOError(f"checkpoint {d} corrupt (sha mismatch)")
        with np.load(npz_path) as z:
            flat = {k: z[k] for k in z.files}
        dtypes = {k: v["dtype"] for k, v in manifest["arrays"].items()}
        return _unflatten_like(like, flat, dtypes), manifest["extra"]
