"""Per-device counters of a traced step: operations and peak memory.

Under a mesh the port's tensors are DTensors, and a dispatch mode sees
each op twice: once on the DTensors (global shapes) and, inside DTensor's
own dispatch, once on each rank's local shards. The reference's numbers
are one device's (XLA's SPMD module), so these modes step aside for the
DTensor-level op (``NotImplemented`` lets DTensor dispatch it) and count
only what reaches the local shards: the local ops, the buffers a
redistribution gathers, the collectives (``hlo.CollectiveCounter``). On
plain tensors they count every op as it comes. DTensor's sharding
propagation works out an output's global shape by running the op on fake
tensors of global shape; that is not work of the step, so while it runs
(``_propagating``, entered around DTensor's
``ShardingPropagator._propagate_tensor_meta_non_cached`` while any counter
is active) the counters pass every op uncounted.
"""
from __future__ import annotations

import threading

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


def on_dtensors(types) -> bool:
    """True when an op's argument types hold a DTensor: DTensor's own
    dispatch will run the local ops, so a per-device counter waits for
    those."""
    return any(issubclass(t, DTensor) for t in types)


_state = threading.local()
_installed = [0, None]           # active counters, the unpatched method


def propagating() -> bool:
    """True inside DTensor's shape propagation (see the module's doc)."""
    return getattr(_state, "depth", 0) > 0


def _install() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if _installed[0] == 0:
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def marked(self, op_schema):
            _state.depth = getattr(_state, "depth", 0) + 1
            try:
                return orig(self, op_schema)
            finally:
                _state.depth -= 1

        _installed[1] = orig
        ShardingPropagator._propagate_tensor_meta_non_cached = marked
    _installed[0] += 1


def _uninstall() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    _installed[0] -= 1
    if _installed[0] == 0:
        ShardingPropagator._propagate_tensor_meta_non_cached = _installed[1]


class _Local:
    """Mixin of the per-device modes: marks DTensor's shape propagation
    while the mode is active."""

    def __enter__(self):
        _install()
        try:
            return super().__enter__()
        except BaseException:
            _uninstall()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _uninstall()


class DeviceFlops(_Local, TorchDispatchMode):
    """The operations of the local ops dispatched inside the ``with``
    block, in ``self.flops``."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not propagating():
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


class PeakMemory(_Local, MemTracker):
    """``MemTracker`` on the local shards; ``peak()`` is the device's peak
    of live bytes, the tensors given to ``track_external`` included."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if on_dtensors(types):
            return NotImplemented
        if propagating():
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def peak(self) -> int:
        snap = self.get_tracker_snapshot("peak")
        return int(sum(v["Total"] for v in snap.values()))
