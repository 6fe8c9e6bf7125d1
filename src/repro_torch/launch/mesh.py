"""Production meshes, the counterpart of ``repro/launch/mesh.py``.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks.  The model axis is the HBD (the OCSTrx ring domain);
data/pod are DCN axes.  ``make_orchestrated_production_mesh`` additionally
routes the rank order through the HBD-DCN orchestrator so the model axis
follows live OCS rings (with faults bypassed).

Each mesh is a ``DeviceMesh`` over the current ``torch.distributed`` world
(one process per GPU).  Its rank grid comes from a host function
(:func:`production_grid`, :func:`orchestrated_production_plan`) that needs
no process group, so the layouts can be checked at 512 ranks anywhere.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np


def _shape(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def production_grid(*, multi_pod: bool = False) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """The production mesh's rank grid (ranks in order) and axis names."""
    shape, axes = _shape(multi_pod)
    return np.arange(int(np.prod(shape))).reshape(shape), axes


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over the current world."""
    from ..parallel.mesh import make_mesh

    shape, axes = _shape(multi_pod)
    return make_mesh(shape, axes, device=device)


def orchestrated_production_plan(world_size: int, *, multi_pod: bool = False,
                                 faults: Optional[Set[int]] = None,
                                 gpus_per_node: int = 4, k: int = 3):
    """The orchestrator's plan for the production mesh on ``world_size``
    ranks grouped into nodes of ``gpus_per_node`` (requires spare capacity
    when faults are present; raises InsufficientCapacityError otherwise)."""
    from ..core.placement import plan_mesh

    pod = 2 if multi_pod else 1
    return plan_mesh(world_size // gpus_per_node, gpus_per_node, tp_size=16, dp_size=16,
                     pod_size=pod, faults=faults or set(), k=k)


def make_orchestrated_production_mesh(*, multi_pod: bool = False,
                                      faults: Optional[Set[int]] = None,
                                      gpus_per_node: int = 4, k: int = 3,
                                      device="cuda"):
    """Rank order decided by the paper's orchestrator over the current
    world; returns the ``DeviceMesh`` and the plan."""
    import torch.distributed as dist

    from ..core.placement import make_orchestrated_mesh

    world = dist.get_world_size()
    plan = orchestrated_production_plan(world, multi_pod=multi_pod, faults=faults,
                                        gpus_per_node=gpus_per_node, k=k)
    return make_orchestrated_mesh(plan, world, device=device), plan
