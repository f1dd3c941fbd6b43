"""Production mesh construction (single-pod 16x16, multi-pod 2x16x16).

Port of ``repro/launch/mesh.py``.  FUNCTIONS, not module constants:
importing this module touches no process group.  Each builds a
``DeviceMesh`` over whatever world the caller has initialised — a fake
world of 256 or 512 ranks in the dry run (``launch/dryrun.py`` alone sets
one up, in its own process), the real ranks elsewhere.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_axes"]


def mesh_axes(shape: tuple) -> tuple:
    """Axis names of a mesh shape: ``("data", "model")`` in 2D,
    ``("pod", "data", "model")`` in 3D."""
    return ("pod", "data", "model")[-len(shape):]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=mesh_axes(shape))


def make_local_mesh():
    """The real cards of this host, ``(device_count, 1)`` as ``("data",
    "model")``, over an initialised world of that many ranks."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", (torch.cuda.device_count(), 1),
                            mesh_dim_names=("data", "model"))
