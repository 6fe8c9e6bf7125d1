"""Control plane: node fabric manager + cluster manager (paper §5.2).

The device level (``NodeFabricManager``) owns the OCSTrx modules of one node
and executes topology switches; the system level (``ClusterManager``) watches
heartbeats, reacts to fault events by re-running the orchestrator, and hands
the training runtime a new ``MeshPlan`` plus the reconfiguration deadline
(when all transceivers have settled).

This is an event-driven simulation of the production control plane; the
training runtime (``repro_torch.train.elastic``) consumes its decisions.

A copy of ``repro.core.control_plane``: on regular fat-tree geometry it
replans through ``repro_torch.dcn.incremental``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .. import obs
from .ocstrx import RECONFIG_LATENCY_US
from .placement import InsufficientCapacityError, MeshPlan, plan_mesh
from .topology import KHopRingTopology, TopologyConfig

# Software-stack delay on top of hardware switching (network-protocol layer
# reconnection; excluded from the paper's 60-80us hardware figure).
PROTOCOL_DELAY_US = 500.0
HEARTBEAT_INTERVAL_S = 5.0
HEARTBEAT_MISS_LIMIT = 3


@dataclasses.dataclass(frozen=True)
class ControlPlaneConfig:
    """Tunable control-plane timing constants.

    Defaults are exactly the historical module constants, so a default
    config changes nothing; churn sweeps (``repro_torch.churn``) construct
    variants to study reconfiguration-latency sensitivity.
    """

    protocol_delay_us: float = PROTOCOL_DELAY_US
    heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S
    heartbeat_miss_limit: int = HEARTBEAT_MISS_LIMIT
    reconfig_latency_us: Tuple[float, float] = RECONFIG_LATENCY_US

    @property
    def heartbeat_timeout_s(self) -> float:
        return self.heartbeat_interval_s * self.heartbeat_miss_limit


@dataclasses.dataclass
class NodeFabricManager:
    """Per-node agent: configures local OCSTrx, reports health."""

    node_id: int
    topo: KHopRingTopology
    last_heartbeat_s: float = 0.0
    config: ControlPlaneConfig = dataclasses.field(
        default_factory=ControlPlaneConfig)

    def heartbeat(self, now_s: float) -> None:
        self.last_heartbeat_s = now_s

    def alive(self, now_s: float) -> bool:
        if self.node_id in self.topo.faulty:
            return False
        return (now_s - self.last_heartbeat_s
                < self.config.heartbeat_timeout_s)

    def apply_segment(self, segment, now_us: float = 0.0, rng=None) -> float:
        """Drive this node's transceivers for a ring segment it belongs to."""
        return self.topo.activate_segment(
            segment, now_us, rng, latency_range=self.config.reconfig_latency_us)


@dataclasses.dataclass
class ReconfigEvent:
    time_s: float
    kind: str                  # "fault" | "repair" | "replan"
    nodes: Tuple[int, ...]
    plan: Optional[MeshPlan] = None
    settle_s: float = 0.0      # when the new topology is live


class ClusterManager:
    """Global controller: faults in -> new MeshPlan out."""

    def __init__(self, num_nodes: int, gpus_per_node: int = 4, k: int = 3,
                 nodes_per_tor: int = 8, agg_domain: int = 64, seed: int = 0,
                 incremental: bool = True,
                 config: Optional[ControlPlaneConfig] = None):
        from .orchestrator import deployment_strategy
        self.cfg = TopologyConfig(num_nodes, gpus_per_node, k)
        self.config = config if config is not None else ControlPlaneConfig()
        # the topology graph lives in HBD-position space (deployment order)
        self.topo = KHopRingTopology(self.cfg)
        self.dep = deployment_strategy(num_nodes, nodes_per_tor)
        self.pos_of = {node: i for i, node in enumerate(self.dep.order)}
        self.k = k
        self.nodes_per_tor = nodes_per_tor
        self.agg_domain = agg_domain
        self.fabric = {u: NodeFabricManager(u, self.topo, config=self.config)
                       for u in range(num_nodes)}
        self.rng = np.random.default_rng(seed)
        self.log: List[ReconfigEvent] = []
        self.current_plan: Optional[MeshPlan] = None
        self.physical_faults: set = set()
        # Incremental orchestration: a delta-updated capacity tracker lets
        # fault/repair events skip the O(cluster) elastic-DP probe ladder,
        # and (on regular fat-tree geometry) a delta-updated tiered-
        # placement tracker replaces the full Algorithm-5 re-orchestration.
        self.incremental = incremental
        self._tracker = None
        self._ft_tracker = None

    # ------------------------------------------------------- capacity view

    def _build_tracker(self, m: int):
        from .orchestrator import IncrementalOrchestrator
        self._tracker = IncrementalOrchestrator(
            self.dep.order, m, self.k, set(self.physical_faults))
        return self._tracker

    def _sync_tracker(self, m: int, kind: str, nodes: Tuple[int, ...]):
        """Keep the incremental orchestrator in lockstep with fault state.

        Applies the event delta when the tracker is current; rebuilds from
        ``physical_faults`` on a TP-size change or any detected desync (e.g.
        events processed while ``incremental`` was off).
        """
        if self._tracker is not None and self._tracker.m == m:
            apply = (self._tracker.fault if kind == "fault"
                     else self._tracker.repair)
            for u in nodes:
                apply(u)
            if self._tracker.faults == self.physical_faults:
                obs.count("control_plane.tracker_delta_apply")
                return self._tracker
        obs.count("control_plane.tracker_rebuild")
        return self._build_tracker(m)

    def _sync_ft_tracker(self, tp_size: int, kind: str,
                         nodes: Tuple[int, ...]):
        """Delta-updated Algorithm-4/5 tracker (regular geometry only).

        Same lockstep contract as :meth:`_sync_tracker`; returns None when
        the cluster geometry is irregular (the caller falls back to the
        full re-orchestration inside ``plan_mesh``).
        """
        from ..dcn.incremental import IncrementalFatTreeOrchestrator
        from ..dcn.kernel import FatTreeConfig
        ft = self._ft_tracker
        if ft is not None and ft.tp_size == tp_size:
            apply = ft.fault if kind == "fault" else ft.repair
            for u in nodes:
                apply(u)
            if ft.faults == self.physical_faults:
                obs.count("control_plane.ft_tracker_delta_apply")
                return ft
        cfg = FatTreeConfig(self.cfg.num_nodes, self.cfg.gpus_per_node,
                            self.nodes_per_tor, self.agg_domain, self.k)
        if not cfg.regular():
            self._ft_tracker = None
            return None
        obs.count("control_plane.ft_tracker_rebuild")
        self._ft_tracker = IncrementalFatTreeOrchestrator(
            self.cfg.num_nodes, self.cfg.gpus_per_node, self.nodes_per_tor,
            self.agg_domain, tp_size, self.k, set(self.physical_faults))
        return self._ft_tracker

    def placeable_gpus(self, tp_size: int) -> int:
        """Current max placeable capacity at ``tp_size`` (delta-maintained)."""
        m = max(1, tp_size // self.cfg.gpus_per_node)
        if (self._tracker is None or self._tracker.m != m
                or self._tracker.faults != self.physical_faults):
            self._build_tracker(m)
        return self._tracker.capacity_nodes() * self.cfg.gpus_per_node

    # ------------------------------------------------------------- events

    def on_fault(self, now_s: float, nodes: Set[int], tp_size: int,
                 dp_size: int, pod_size: int = 1) -> ReconfigEvent:
        """Node fault(s): mark them, re-orchestrate, compute settle time."""
        self.physical_faults |= set(nodes)
        self.topo.inject_faults(self.pos_of[u] for u in nodes)
        return self._replan(now_s, tuple(nodes), "fault", tp_size, dp_size,
                            pod_size)

    def on_repair(self, now_s: float, nodes: Set[int], tp_size: int,
                  dp_size: int, pod_size: int = 1) -> ReconfigEvent:
        self.physical_faults -= set(nodes)
        self.topo.repair(self.pos_of[u] for u in nodes)
        return self._replan(now_s, tuple(nodes), "repair", tp_size, dp_size,
                            pod_size)

    def _replan(self, now_s: float, nodes: Tuple[int, ...], kind: str,
                tp_size: int, dp_size: int, pod_size: int) -> ReconfigEvent:
        plan = None
        dp = dp_size
        cap_groups = None
        ft = None
        if self.incremental:
            # Delta-updated capacity: Algorithm 5 with 0 constraints degrades
            # to the unconstrained pass, so DCN-free capacity is exactly the
            # feasibility frontier -- infeasible DP degrees are skipped
            # without running the orchestrator at all.
            tracker = self._sync_tracker(max(1, tp_size // self.cfg.gpus_per_node),
                                         kind, nodes)
            cap_groups = tracker.capacity_groups()
            ft = self._sync_ft_tracker(tp_size, kind, nodes)
        # Elastic scaling: shrink DP degree until the orchestrator can place
        # the job on the healthy subgraph (the paper's single-job priority).
        while dp >= 1:
            if cap_groups is not None and dp * pod_size > cap_groups:
                dp //= 2
                continue
            # Tiered placement from the delta-updated fat-tree tracker
            # (equal to full re-orchestration) when available.
            placement = (ft.orchestrate(dp * pod_size * tp_size)
                         if ft is not None else None)
            if ft is not None and placement is None:
                dp //= 2
                continue
            try:
                plan = plan_mesh(self.cfg.num_nodes, self.cfg.gpus_per_node,
                                 tp_size, dp, pod_size,
                                 faults=set(self.physical_faults), k=self.k,
                                 nodes_per_tor=self.nodes_per_tor,
                                 agg_domain=self.agg_domain,
                                 placement=placement)
                break
            except InsufficientCapacityError:
                dp //= 2
        if plan is None:
            raise InsufficientCapacityError(
                f"cluster cannot host even TP={tp_size} x DP=1 after {kind}")

        # Settle time: every affected segment reconfigures in parallel; the
        # hardware switch is 60-80us + protocol-layer delay.  Switches start
        # at the event time (not sim-time 0) so a transceiver's busy window
        # from an earlier event never bleeds into this one's latency.
        now_us = now_s * 1e6
        settle_us = now_us
        for seg in plan.segments_pos:
            settle_us = max(settle_us, self.topo.activate_segment(
                seg, now_us, self.rng,
                latency_range=self.config.reconfig_latency_us))
        settle_s = now_s + (settle_us - now_us
                            + self.config.protocol_delay_us) / 1e6
        ev = ReconfigEvent(now_s, kind, nodes, plan, settle_s)
        self.log.append(ev)
        self.current_plan = plan
        return ev

    # ----------------------------------------------------------- stragglers

    def flag_stragglers(self, step_times_s: Dict[int, float],
                        threshold: float = 1.5) -> Set[int]:
        """Nodes whose step time exceeds ``threshold`` x median are flagged;
        the caller treats them like faults at the next ring rebuild (the
        K-hop backup links make the swap as cheap as a bypass)."""
        if not step_times_s:
            return set()
        med = float(np.median(list(step_times_s.values())))
        flagged = {u for u, t in step_times_s.items()
                   if t > threshold * med}
        if flagged:
            obs.count("control_plane.stragglers_flagged", len(flagged))
        return flagged
