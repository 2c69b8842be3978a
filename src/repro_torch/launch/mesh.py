"""Production meshes, a port of ``repro.launch.mesh``: functions only, so
importing this module never touches ``torch.distributed``.

A mesh is ``init_device_mesh(device_type, cfg.shape,
mesh_dim_names=cfg.axes)`` over the initialized process group, one rank a
device; ``device_type`` is ``"cuda"`` by default and ``"cpu"`` for
``gloo`` ranks. Nothing tells a program of a cluster: the caller
initializes the process group with its own address, world size and
rank."""
from __future__ import annotations

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 0


def make_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``cfg.shape`` with dims named ``cfg.axes``.
    Raises when the process group has too few ranks (or none)."""
    from torch.distributed.device_mesh import init_device_mesh

    have, need = _world_size(), cfg.num_devices
    if have < need:
        raise ValueError(
            f"mesh {cfg.shape} needs {need} ranks, have {have} (initialize "
            "the process group with that world size first)")
    return init_device_mesh(device_type, cfg.shape,
                            mesh_dim_names=tuple(cfg.axes))


def try_make_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    """``make_mesh`` that returns ``None`` instead of raising when the
    process group does not have enough ranks."""
    if _world_size() < cfg.num_devices:
        return None
    return make_mesh(cfg, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) = (data, model) single pod; (2, 16, 16) = (pod, data,
    model) across two pods."""
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD, device_type)
