"""Device meshes: the JAX package's ``launch/mesh.py`` on
``torch.distributed.device_mesh``.

Both build on the current process group (``init_process_group`` first) and
put the mesh on the card unless the caller passes ``device="cpu"``; they
raise when the group's size is not the mesh's."""
from __future__ import annotations

import math

import torch.distributed as dist


def _mesh(shape: tuple, names: tuple, device: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_local_mesh(model: int = 1, *, device: str = "cuda"):
    """(world // model, model) over ("data", "model") on the current group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((max(n // model, 1), model), ("data", "model"), device)
