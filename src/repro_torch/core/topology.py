"""Reconfigurable K-Hop Ring topology (paper §4.2).

Nodes are arranged on a line (optionally closed into a ring).  Each node owns
``K`` OCSTrx bundles wired to nodes at distance ±1..±K; during normal operation
only the ±1 links are active and the rest are cold backups.  A run of up to
K-1 consecutive failed nodes can be bypassed by activating a backup link, so
the fault explosion radius is a single node.

The intra-node loopback mechanism turns a node-level *line* segment into a
GPU-level *ring*: traffic flows "out" along the upper-half GPUs of each node
and "back" along the lower half, closing through the cross-lane loopback paths
of the two end nodes.  ``gpu_ring`` materializes that boustrophedon order --
it is exactly the device order of a training mesh's TP axis.

A copy of ``repro.core.topology``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .ocstrx import OCSTrxBundle, Path


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    num_nodes: int
    gpus_per_node: int = 4      # R
    k_hops: int = 3             # K: bundles per node / max bypass reach
    closed_ring: bool = True    # N_1 may link to the last node, forming a ring
    trx_per_bundle: int = 8     # 8x800G per 6.4Tbps GPU pair


class KHopRingTopology:
    """Datacenter-scale K-hop ring with OCSTrx edge state."""

    def __init__(self, cfg: TopologyConfig):
        self.cfg = cfg
        n = cfg.num_nodes
        if n < 2:
            raise ValueError("need at least 2 nodes")
        if cfg.k_hops < 1:
            raise ValueError("K must be >= 1")
        self.faulty: Set[int] = set()
        # One bundle per hop distance per direction is the physical upper
        # bound; the paper uses K bundles (2K external paths) per node.
        self.bundles: Dict[int, List[OCSTrxBundle]] = {
            u: [OCSTrxBundle(f"n{u}.b{k}", width=cfg.trx_per_bundle)
                for k in range(cfg.k_hops)]
            for u in range(n)
        }

    # ---------------------------------------------------------------- graph

    def distance(self, u: int, v: int) -> int:
        """Hop distance along the deployment order."""
        d = abs(u - v)
        if self.cfg.closed_ring:
            d = min(d, self.cfg.num_nodes - d)
        return d

    def neighbors(self, u: int) -> List[int]:
        """All nodes physically wired to ``u`` (within K hops)."""
        n, k = self.cfg.num_nodes, self.cfg.k_hops
        out = []
        for off in range(1, k + 1):
            for v in ((u + off) % n, (u - off) % n):
                if self.cfg.closed_ring or abs(u - v) <= k:
                    if v != u and v not in out:
                        out.append(v)
        if not self.cfg.closed_ring:
            out = [v for v in out if abs(u - v) <= k]
        return out

    def edges(self) -> List[Tuple[int, int]]:
        """Undirected wired edge set {(u,v): dist<=K}."""
        n, k = self.cfg.num_nodes, self.cfg.k_hops
        es = []
        for u in range(n):
            for off in range(1, k + 1):
                v = u + off
                if v < n:
                    es.append((u, v))
                elif self.cfg.closed_ring:
                    es.append((u, v % n))
        return es

    # ---------------------------------------------------------------- faults

    def inject_faults(self, nodes: Iterable[int]) -> None:
        for u in nodes:
            self.faulty.add(u)
            for b in self.bundles[u]:
                for m in b.modules:
                    m.fail()

    def repair(self, nodes: Iterable[int]) -> None:
        for u in nodes:
            self.faulty.discard(u)
            self.bundles[u] = [
                OCSTrxBundle(f"n{u}.b{k}", width=self.cfg.trx_per_bundle)
                for k in range(self.cfg.k_hops)
            ]

    def healthy_nodes(self) -> List[int]:
        return [u for u in range(self.cfg.num_nodes) if u not in self.faulty]

    # ----------------------------------------------------- components / rings

    def healthy_components(self) -> List[List[int]]:
        """Maximal runs of healthy nodes connectable with <=K-hop jumps.

        Two consecutive healthy nodes belong to the same component iff the gap
        of faulty nodes between them is at most K-1 (a backup link of reach K
        bridges it).  On a closed ring, the first and last run merge if the
        wrap-around gap also satisfies the bound.
        """
        h = self.healthy_nodes()
        if not h:
            return []
        k = self.cfg.k_hops
        comps: List[List[int]] = [[h[0]]]
        for prev, cur in zip(h, h[1:]):
            if cur - prev <= k:
                comps[-1].append(cur)
            else:
                comps.append([cur])
        if self.cfg.closed_ring and len(comps) > 1:
            wrap_gap = (h[0] + self.cfg.num_nodes) - h[-1]
            if wrap_gap <= k:
                comps[0] = comps[-1] + comps[0]
                comps.pop()
        return comps

    def bypass_plan(self, segment: Sequence[int]) -> List[Tuple[int, int, int]]:
        """For a chosen segment of healthy nodes, list the activated external
        links as (u, v, hop_distance).  Raises if any jump exceeds K."""
        plan = []
        for u, v in zip(segment, segment[1:]):
            d = self.distance(u, v)
            if d > self.cfg.k_hops:
                raise ValueError(f"segment jump {u}->{v} exceeds K={self.cfg.k_hops}")
            plan.append((u, v, d))
        return plan

    def activate_segment(self, segment: Sequence[int], now_us: float = 0.0,
                         rng=None,
                         latency_range: Optional[Tuple[float, float]] = None) -> float:
        """Drive OCSTrx state for a node segment forming one TP ring.

        Interior nodes activate the two external paths toward their segment
        neighbors; the two end nodes activate one external path and the
        cross-lane loopback (closing the GPU ring).  Returns the sim time at
        which every involved transceiver has settled -- the topology-level
        reconfiguration latency.  ``latency_range`` overrides the per-switch
        hardware latency (see ``ControlPlaneConfig``).
        """
        settle = now_us
        plan = self.bypass_plan(segment)
        for u, v, d in plan:
            bu = self.bundles[u][d - 1]
            bv = self.bundles[v][d - 1]
            # primary neighbor rides EXT1, bypass links ride EXT2
            path = Path.EXT1 if d == 1 else Path.EXT2
            settle = max(settle, bu.switch_all(path, now_us, rng, latency_range))
            settle = max(settle, bv.switch_all(path, now_us, rng, latency_range))
        for end in (segment[0], segment[-1]):
            # remaining bundles at the ends close the ring via loopback
            for b in self.bundles[end][1:]:
                if b.healthy:
                    settle = max(settle, b.switch_all(Path.LOOPBACK, now_us,
                                                      rng, latency_range))
        return settle

    # ------------------------------------------------------------- GPU rings

    def gpu_ring(self, segment: Sequence[int]) -> List[Tuple[int, int]]:
        """GPU-level ring order for a node segment (boustrophedon walk).

        Returns ``len(segment) * R`` (node, local_gpu) pairs: out along the
        upper-half GPUs of each node, back along the lower half, closed by the
        end nodes' loopback paths.  Consecutive entries are physically
        adjacent (same node, or nodes within K hops), which is what makes a
        ppermute ring all-reduce traverse only live OCS links.
        """
        r = self.cfg.gpus_per_node
        upper = list(range(r // 2))
        lower = list(range(r // 2, r))
        ring: List[Tuple[int, int]] = []
        for u in segment:
            ring.extend((u, g) for g in upper)
        for u in reversed(segment):
            ring.extend((u, g) for g in reversed(lower))
        return ring

    def waste_report(self, tp_nodes: int) -> Dict[str, float]:
        """Fragmentation accounting for TP groups of ``tp_nodes`` nodes."""
        total = self.cfg.num_nodes * self.cfg.gpus_per_node
        faulty = len(self.faulty) * self.cfg.gpus_per_node
        placed = 0
        for comp in self.healthy_components():
            placed += (len(comp) // tp_nodes) * tp_nodes
        placed_gpus = placed * self.cfg.gpus_per_node
        healthy_gpus = total - faulty
        return {
            "total_gpus": total,
            "faulty_gpus": faulty,
            "placed_gpus": placed_gpus,
            "wasted_gpus": healthy_gpus - placed_gpus,
            "waste_ratio": (healthy_gpus - placed_gpus) / total,
        }
