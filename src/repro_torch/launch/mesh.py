"""Production mesh definition (port of ``repro.launch.mesh``).

A FUNCTION, not a module constant: importing this module touches no
process group.  The caller brings up a process group of 256 ranks (or
512 for the 2-pod mesh) first: ``torch.distributed`` ranks, or a fake
group for a dry run (``launch.dryrun``)."""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _names(mesh) -> tuple:
    return tuple(mesh) if isinstance(mesh, dict) else tuple(mesh.mesh_dim_names)


def dp_axes(mesh) -> tuple:
    """Axes carrying the batch: ('pod','data') multi-pod, ('data',) single
    (``mesh``: a ``DeviceMesh`` or its ``{axis: size}``)."""
    return tuple(a for a in _names(mesh) if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"
