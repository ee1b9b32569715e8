"""Production and test meshes (port of ``src/repro/launch/mesh.py``).

Functions, never module-level constants: importing this module touches
no process group and no device. Each builds a ``DeviceMesh`` with the
reference's shape and axis names over the world the caller initialized
(``torch.distributed.init_process_group``: one process per rank, the
backend the caller's), and raises, naming the world size it needs, when
the world does not match.
"""

from __future__ import annotations

import math


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str,
          who: str):
    import torch.distributed as dist
    need = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"{who}: the {shape} mesh needs an initialized "
                           f"world of {need} ranks, and no process group "
                           f"is initialized")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"{who}: the {shape} mesh needs a world of {need} "
                           f"ranks; the initialized world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 ("data", "model"), 256 ranks, or 2x16x16 ("pod", "data",
    "model"), 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type, "make_production_mesh")


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   device_type: str = "cuda"):
    """A small ("data", "model") mesh (the tests pass
    ``device_type="cpu"`` over a gloo world)."""
    return _mesh((n_data, n_model), ("data", "model"), device_type,
                 "make_test_mesh")


def dp_size(mesh) -> int:
    """The product of the mesh's data-parallel axes ("pod", "data")."""
    names = tuple(mesh.mesh_dim_names or ())
    size = 1
    for a in ("pod", "data"):
        if a in names:
            size *= mesh.size(names.index(a))
    return size
