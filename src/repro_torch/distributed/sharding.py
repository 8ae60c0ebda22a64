"""Logical-axis sharding rules: the JAX package's ``distributed/sharding.py``
on a ``torch.distributed`` ``DeviceMesh``.

Models name the axes of their parameters and activations *logically*
("batch", "heads", "d_ff", ...); a rule table maps each logical name to a
mesh axis ("pod", "data", "model"), a tuple of them, or None. JAX hands the
resulting ``PartitionSpec`` to GSPMD; here a spec becomes one DTensor
placement per mesh dim (:func:`placements`), parameters become DTensors
(:func:`shard_params`, what ``jit``'s ``in_shardings`` do) and
``with_sharding_constraint`` becomes ``DTensor.redistribute``
(:func:`shard_hint`). Outside a mesh context every hint returns its input
untouched, so the single-device paths run exactly as they did.

A spec here is a tuple with one entry per tensor dim: None, a mesh axis
name, or a tuple of names (one tensor dim split over several mesh axes).
DTensor splits such a dim over its mesh dims in the mesh's order, as JAX
does for a tuple that follows the mesh's order; a tuple out of that order
raises. :func:`local_shape` is the shape of one shard, JAX's
``NamedSharding.shard_shape``: it raises where a dim does not divide, as
JAX does (DTensor itself would cut such a dim unevenly, ``torch.chunk``'s
way).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Mapping, Optional, Sequence

import torch

AxisRules = dict  # logical name -> mesh axis name, tuple of names, or None

# LM default: batch over (pod, data); heads/ffn/vocab/experts over model.
DEFAULT_LM_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "experts": "model",
    "expert_ff": None,
    "vocab": "model",
    "table_rows": "model",
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "docid": "model",
    "candidates": "model",
}

_ctx = threading.local()


def set_mesh(mesh, rules: Optional[AxisRules] = None):
    _ctx.mesh = mesh
    _ctx.rules = rules or DEFAULT_LM_RULES


def get_mesh():
    """The thread's ``DeviceMesh``, or None outside a mesh context."""
    return getattr(_ctx, "mesh", None)


def get_rules() -> AxisRules:
    return getattr(_ctx, "rules", DEFAULT_LM_RULES)


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[AxisRules] = None):
    old_mesh, old_rules = get_mesh(), get_rules()
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        set_mesh(old_mesh, old_rules)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of such a dict itself (a
    mesh described without devices, as the production meshes are in tests)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(logical: Sequence[Optional[str]], axis_names: Sequence[str],
             rules: AxisRules) -> tuple:
    """JAX's ``_spec_for``: each logical name through ``rules``, keeping only
    the mesh's axes; a mesh axis already used by an earlier dim of the
    tensor leaves a later dim unsharded (the first mapping wins)."""
    parts = []
    used: set = set()
    for name in logical:
        axis = None if name is None else rules.get(name)
        if axis is None:
            parts.append(None)
        elif isinstance(axis, tuple):
            axis = tuple(a for a in axis if a in axis_names and a not in used)
            used.update(axis)
            parts.append(axis if axis else None)
        elif axis not in axis_names or axis in used:
            parts.append(None)
        else:
            used.add(axis)
            parts.append(axis)
    return tuple(parts)


def _axes_of(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def placements(spec: Sequence, mesh) -> tuple:
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dim, in the mesh's
    order. A mesh dim of size 1 splits nothing and stays ``Replicate()``
    (DTensor then never sees a dim of size 1 sharded, which its view rules
    refuse to flatten)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for p in pos:
            if sizes[names[p]] > 1:
                out[p] = Shard(dim)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """The shape of one shard: JAX's ``NamedSharding(mesh, spec).shard_shape``.
    Raises ``ValueError`` where a sharded dim does not divide."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes_of(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide into {n} shards "
                             f"(spec {tuple(spec)})")
        out[dim] //= n
    return tuple(out)


def logical_sharding(logical: Sequence[Optional[str]], mesh=None,
                     rules: Optional[AxisRules] = None) -> Optional[tuple]:
    """The placements that ``logical`` maps to on ``mesh`` (default: the
    context's), or None without a mesh."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return None
    return placements(spec_for(logical, mesh.mesh_dim_names, rules or get_rules()), mesh)


def as_dtensor(x: torch.Tensor, mesh):
    """A plain tensor that holds the same global value on every rank, as a
    replicated DTensor (no communication); a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def shard_hint(x, *logical: Optional[str]):
    """``with_sharding_constraint`` by logical names: under a mesh, ``x`` (a
    DTensor, or a plain tensor holding the global value on every rank)
    redistributed to the placements the names map to; without one, ``x``."""
    pl = logical_sharding(logical)
    if pl is None:
        return x
    x = as_dtensor(x, get_mesh())
    return x if tuple(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def tree_shardings(axes: dict, mesh=None, rules: Optional[AxisRules] = None) -> dict:
    """{name: logical axes} -> {name: placements} (None without a mesh)."""
    return {n: logical_sharding(ax, mesh, rules) for n, ax in axes.items()}


def zero1_shardings(shapes: dict, specs: dict, mesh) -> dict:
    """ZeRO-1: a moment buffer's spec is its parameter's, with the first
    still-unsharded dim that ``data`` divides split over ``data`` as well
    (when the parameter's spec uses no ``data`` yet). ``shapes`` {name:
    shape}, ``specs`` {name: spec} -> {name: spec}, as JAX's
    ``zero1_shardings``; applying them to the optimizer's moments waits for
    the mesh lowering of the train cells."""
    data = mesh_shape(mesh).get("data", 1)

    def one(shape, spec):
        spec = list(spec or ())
        spec += [None] * (len(shape) - len(spec))
        if data > 1 and not any("data" in _axes_of(e) for e in spec):
            for i, n in enumerate(shape):
                if spec[i] is None and n % data == 0:
                    spec[i] = "data"
                    break
        return tuple(spec)

    return {n: one(tuple(shapes[n]), specs[n]) for n in shapes}


def shard_params(module: torch.nn.Module, axes: dict, mesh,
                 rules: Optional[AxisRules] = None) -> torch.nn.Module:
    """Every parameter of ``module`` (``axes`` names each) becomes a DTensor
    on ``mesh`` under the placements its logical axes map to (what
    ``jit``'s ``in_shardings`` do). Plain parameters must hold the same
    values on every rank: each keeps its own shard, with no communication;
    DTensor parameters are redistributed (new rules on the same mesh). In
    place; returns ``module``."""
    rules = rules or get_rules()
    for name, p in list(module.named_parameters()):
        pl = placements(spec_for(axes[name], mesh.mesh_dim_names, rules), mesh)
        d = as_dtensor(p.detach(), mesh).redistribute(mesh, pl)
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, torch.nn.Parameter(d, requires_grad=p.requires_grad))
    return module


def plain_as_replicated():
    """While a mesh is set: a context in which a plain tensor that meets a
    DTensor counts as replicated (``implicit_replication``) -- the
    positions, RoPE angles and scalars that a block makes hold the same
    value on every rank. Without a mesh: a context that does nothing."""
    if get_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def no_grad_serving(fn):
    """Decorator for a serving entry point: ``torch.inference_mode()``, or
    ``torch.no_grad()`` while a mesh is set (DTensor cannot take views of
    its parameters in inference mode)."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad() if get_mesh() is not None else torch.inference_mode():
            return fn(*args, **kwargs)

    return run
