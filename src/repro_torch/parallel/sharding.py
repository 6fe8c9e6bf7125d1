"""Logical-axis sharding rules (MaxText-style), the counterpart of
``repro/parallel/sharding.py``.

The launcher installs a rule set mapping logical axis names to physical mesh
axes, and the mesh (a ``DeviceMesh``, :mod:`repro_torch.parallel.mesh`).
With no rules installed (unit tests, one process) the model code runs its
unsharded path.  ``repro`` keeps the rules and mesh thread-local; in the
port every rank is its own process, so they are module state, one copy a
rank, and every thread of the rank sees them (CUDA autograd runs the
backward, and so each remat recompute, on a device thread of its own).

In ``repro`` the rules drive GSPMD: ``shard`` puts a sharding constraint on
a global array and the partitioner splits the work.  The port has no
partitioner.  Each rank holds its shards explicitly (weights cut by
:func:`repro_torch.parallel.specs.shard_tensor`, the batch by the caller),
and the model code reads the rules to find the mesh axis of each logical
one and runs the collectives of :mod:`repro_torch.parallel.collectives`
there.  So :func:`resolve` gives the port's own spec, a tuple of mesh-axis
names or None per dimension, and :func:`shard` returns its input.

Physical mesh axes (``repro_torch.launch.mesh``):
  * ``model``  -- the HBD / TP ring axis (the paper's OCSTrx domain)
  * ``data``   -- intra-pod DP (DCN, ToR-local after orchestration)
  * ``pod``    -- cross-pod DP (multi-pod mesh only)
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple, Union

from .mesh import mesh_axis

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# Default logical->physical rules for the production mesh.
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,            # sequence replicated by default
    "seq_sp": "model",      # sequence parallelism: residual stream (and its
                            # remat-saved copies) seq-sharded over TP; GSPMD
                            # turns the TP all-reduces into RS+AG pairs
    "seq_shard": "data",    # long-context decode: KV cache sharded over data
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "embed": None,          # d_model replicated
    "experts": None,        # TP-MoE (paper default): experts replicated,
                            # each expert's ff sharded on "model"
    "experts_ep": "model",  # EP mode: experts sharded on the model axis
    "layers": None,
}

_rules: Optional[Dict[str, Axis]] = None
_mesh = None


def set_rules(rules: Optional[Dict[str, Axis]]) -> None:
    global _rules
    _rules = rules


def get_rules() -> Optional[Dict[str, Axis]]:
    return _rules


def set_mesh(mesh) -> None:
    global _mesh
    _mesh = mesh


def get_mesh():
    return _mesh


@contextmanager
def parallel_rules(rules: Optional[Dict[str, Axis]], mesh=None):
    prev, prev_mesh = get_rules(), get_mesh()
    set_rules(rules)
    set_mesh(mesh)
    try:
        yield
    finally:
        set_rules(prev)
        set_mesh(prev_mesh)


def logical(*axes: Optional[str]) -> Tuple[Optional[str], ...]:
    """Readability alias: logical("batch", None, "ff")."""
    return axes


def resolve(axes: Tuple[Optional[str], ...]) -> Optional[Spec]:
    """Map logical axes to mesh axes under the installed rules: one entry
    per dimension, a mesh-axis name, a tuple of them or None.  None without
    rules."""
    rules = get_rules()
    if rules is None:
        return None
    return tuple(None if ax is None else rules.get(ax) for ax in axes)


def shard(x, axes: Tuple[Optional[str], ...]):
    """Returns ``x``: in the port each rank already holds its shard, and
    the model code runs the collectives itself (module docstring)."""
    return x


def seq_sp_axis():
    """The installed mesh's :class:`~repro_torch.parallel.mesh.Axis` that
    the rules map ``seq_sp`` to (sequence parallelism), or None off a mesh
    or when they do not map it."""
    rules, mesh = get_rules(), get_mesh()
    if mesh is None or rules is None or rules.get("seq_sp") is None:
        return None
    return mesh_axis(mesh, rules["seq_sp"])


def mesh_axes(rules: Optional[Dict[str, Axis]] = None,
              multi_pod: bool = False) -> Dict[str, Axis]:
    """Rule set for the production meshes; single-pod drops the pod axis."""
    r = dict(DEFAULT_RULES)
    if rules:
        r.update(rules)
    if not multi_pod:
        r = {k: _drop_pod(v) for k, v in r.items()}
    return r


def _drop_pod(v: Axis) -> Axis:
    if v == "pod":
        return None
    if isinstance(v, tuple):
        t = tuple(a for a in v if a != "pod")
        return t if len(t) > 1 else (t[0] if t else None)
    return v
