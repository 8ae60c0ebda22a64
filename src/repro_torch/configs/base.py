"""The (arch x shape) cell record shared by every config, and
``batch_axes``.

The JAX package's ``Lowerable`` and ``mesh_wrapped`` lower a cell onto a
mesh; they come with the port's dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                     # train | prefill | decode | serve | retrieval
    skip: Optional[str] = None    # reason if inapplicable (still reported)


def batch_axes(mesh) -> tuple:
    """The mesh's batch axes: ``pod`` and ``data``, those it has."""
    names = mesh.mesh_dim_names if hasattr(mesh, "mesh_dim_names") else tuple(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
