"""Bridge from HBD orchestration to training meshes: the host part.

This is where the paper's technique becomes a first-class framework feature:
the orchestrator's placement scheme (ordered TP groups of K-hop-connected
nodes) decides the *device order* of the ``model`` axis in the mesh, and
the DP ring order of the ``data``/``pod`` axes.  A ppermute ring all-reduce
over the resulting mesh then only ever talks to physical ring neighbors --
i.e. live OCSTrx links.

Two coordinate systems (paper §4.3 deployment phase):
  * *physical node id*  -- position in the DCN racks; ToR = id // p.
  * *HBD position*      -- index in the deployment order ``dep.order``;
    K-hop OCSTrx wiring connects HBD positions at distance <= K (which is
    physical distance p, 2p, ... across ToRs).
The orchestrator emits physical ids; all topology operations (bypass reach,
ring building, OCSTrx activation) happen in HBD-position space.

Device model: the devices are grouped into virtual nodes of
``gpus_per_node`` consecutive devices; virtual node ids follow device ids.
In the port a device is a rank of the ``torch.distributed`` world (one
process per GPU), so device ids are global ranks.

A copy of ``repro.core.placement``; its mesh builder,
``make_orchestrated_mesh``, builds a ``DeviceMesh`` whose rank tensor is
the plan's ``device_grid``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

import numpy as np

from .orchestrator import (Deployment, Placement, cross_tor_traffic,
                           deployment_strategy, greedy_baseline,
                           orchestrate_fat_tree)
from .topology import KHopRingTopology, TopologyConfig


class InsufficientCapacityError(RuntimeError):
    """Raised when faults leave too few K-hop-connected nodes for the mesh."""


@dataclasses.dataclass
class MeshPlan:
    """A fully resolved physical plan for one training mesh."""

    placement: Placement                    # ordered TP groups (physical ids)
    segments_pos: List[List[int]]           # same groups in HBD positions
    gpu_rings: List[List[Tuple[int, int]]]  # per group: (node, local_gpu) ring
    device_grid: np.ndarray                 # mesh-shaped array of device ids
    axis_names: Tuple[str, ...]
    deployment: Deployment
    cross_tor: dict


def plan_mesh(num_nodes: int, gpus_per_node: int, tp_size: int,
              dp_size: int, pod_size: int = 1, *,
              faults: Optional[Set[int]] = None, k: int = 3,
              nodes_per_tor: int = 8, agg_domain: int = 64,
              orchestrated: bool = True, seed: int = 0,
              placement: Optional[Placement] = None) -> MeshPlan:
    """Run the HBD-DCN orchestrator and lay TP groups onto a mesh grid.

    The returned ``device_grid`` has shape (pod, dp, tp) (pod axis dropped if
    ``pod_size == 1``); entry [i, j, :] is the GPU ring of one TP group.

    ``placement`` short-circuits the orchestrator with a pre-computed
    scheme (e.g. from ``repro.dcn.IncrementalFatTreeOrchestrator``, whose
    delta-updated placements equal ``orchestrate_fat_tree``); the mesh
    layout and traffic accounting are identical either way.
    """
    faults = faults or set()
    dep = deployment_strategy(num_nodes, nodes_per_tor)
    groups_needed = dp_size * pod_size
    job_gpus = groups_needed * tp_size
    if placement is not None:
        pass
    elif orchestrated:
        placement = orchestrate_fat_tree(
            num_nodes, gpus_per_node, nodes_per_tor, faults, tp_size,
            job_gpus, agg_domain, k)
    else:
        placement = greedy_baseline(num_nodes, gpus_per_node, faults,
                                    tp_size, job_gpus, k, seed,
                                    order=dep.order)
    if placement is None or len(placement) < groups_needed:
        got = 0 if placement is None else len(placement)
        raise InsufficientCapacityError(
            f"need {groups_needed} TP groups of {tp_size} GPUs, "
            f"orchestrator found {got} (faults={len(faults)})")
    placement = placement[:groups_needed]

    pos_of = {node: i for i, node in enumerate(dep.order)}
    segments_pos = [[pos_of[u] for u in grp] for grp in placement]

    topo = KHopRingTopology(TopologyConfig(num_nodes, gpus_per_node, k))
    topo.inject_faults(pos_of[u] for u in faults if u in pos_of)
    rings_pos = [topo.gpu_ring(seg) for seg in segments_pos]
    # map HBD positions back to physical node ids for device assignment
    rings = [[(dep.order[p], g) for (p, g) in ring] for ring in rings_pos]

    grid = np.empty((pod_size, dp_size, tp_size), dtype=np.int64)
    for gi, ring in enumerate(rings):
        pod, dp = divmod(gi, dp_size)
        for ti, (node, local) in enumerate(ring):
            grid[pod, dp, ti] = node * gpus_per_node + local
    axis_names: Tuple[str, ...] = ("pod", "data", "model")
    if pod_size == 1:
        grid = grid[0]
        axis_names = ("data", "model")
    return MeshPlan(placement, segments_pos, rings, grid, axis_names, dep,
                    cross_tor_traffic(placement, nodes_per_tor,
                                      agg_domain=agg_domain))


def orchestrated_grid(plan: MeshPlan, world_size: int) -> np.ndarray:
    """The rank grid of ``plan`` (its ``device_grid``), checked against a
    world of ``world_size`` ranks: raises InsufficientCapacityError, with
    ``repro``'s message, if the plan names a rank the world lacks."""
    flat = plan.device_grid.reshape(-1)
    if flat.max() >= world_size:
        raise InsufficientCapacityError(
            f"plan references device {int(flat.max())} but only "
            f"{world_size} devices exist")
    return plan.device_grid


def make_orchestrated_mesh(plan: MeshPlan, world_size: Optional[int] = None, *,
                           device="cuda"):
    """A ``DeviceMesh`` whose rank layout follows ``plan``: its rank tensor
    is ``plan.device_grid``, its dimension names ``plan.axis_names``, so
    the ``model`` axis runs along the orchestrator's GPU rings.  The world
    (``world_size`` ranks, by default the current one) must hold every rank
    the plan names.  ``device`` is the mesh's device type ("cuda" raises
    without a card)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..parallel.mesh import device_type

    kind = device_type(device)
    world = dist.get_world_size() if world_size is None else world_size
    grid = orchestrated_grid(plan, world)
    return DeviceMesh(kind, torch.as_tensor(grid), mesh_dim_names=plan.axis_names)


def ring_adjacency_ok(plan: MeshPlan, k: int, gpus_per_node: int) -> bool:
    """Invariant: consecutive GPUs on each model-axis ring are co-located or
    on nodes within K HBD hops (i.e. reachable over a single live OCS link)."""
    pos_of = {node: i for i, node in enumerate(plan.deployment.order)}
    for ring in plan.gpu_rings:
        n = len(ring)
        for i in range(n):
            (u, _), (v, _) = ring[i], ring[(i + 1) % n]
            if u != v and abs(pos_of[u] - pos_of[v]) > k:
                return False
    return True
