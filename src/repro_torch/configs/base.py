"""The (arch x shape) cell record shared by every config.

The JAX package's ``Lowerable``, ``mesh_wrapped`` and ``NamedSharding``
helpers lower a cell onto a TPU mesh; they wait for the port's distribution
work.
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
