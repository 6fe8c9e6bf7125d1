"""Incremental Algorithm-4/5 orchestration: delta fault/repair updates.

``IncrementalOrchestrator`` (repro_torch.core) delta-maintains the *DCN-free*
placement; this module extends the same event model to the fat-tree
constrained tiers, closing the ROADMAP's "fat-tree-constrained incremental
path" item.  The structural observation: Algorithm 4 is a collection of
independent DCN-free carves -- one per (aggregation domain x sub-line)
chunk, under either the raw or the ToR-aligned fault view -- plus a
residual carve and a deterministic sort.  So the tracker keeps one
:class:`~repro_torch.core.orchestrator.IncrementalOrchestrator` per chunk *per
view* (2 x D x p small trackers), and a fault/repair event touches exactly
one raw tracker plus, on a ToR 0<->1 occupancy transition, the p aligned
trackers of that ToR's domain -- O(chunk) work instead of a full
re-orchestration.

``orchestrate(job_gpus)`` then replays Algorithm 5's binary search on the
delta-maintained chunk counts (the residual count is a vectorized
:func:`~repro_torch.dcn.kernel.line_carve` over the used/fault mask) and
materializes the placement only once, at the level the search settles on.
The result is **equal to ``orchestrate_fat_tree``** after any event
sequence (pinned by ``tests/test_torch_dcn.py``).

A copy of ``repro.dcn.incremental``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.orchestrator import (IncrementalOrchestrator, Placement,
                                 deployment_strategy)
from .kernel import FatTreeConfig, segment_placed_counts, stream_placed_cols


class IncrementalFatTreeOrchestrator:
    """Algorithm 4/5 with delta updates on single fault/repair events."""

    def __init__(self, num_nodes: int, gpus_per_node: int = 4,
                 nodes_per_tor: int = 8, agg_domain: int = 64,
                 tp_size: int = 32, k: int = 3,
                 faults: Optional[Set[int]] = None):
        self.cfg = FatTreeConfig(num_nodes, gpus_per_node, nodes_per_tor,
                                 agg_domain, k)
        if not self.cfg.regular():
            raise ValueError(
                "IncrementalFatTreeOrchestrator requires regular geometry "
                "(nodes_per_tor | agg_domain | num_nodes)")
        self.tp_size = tp_size
        self.m = self.cfg.group_nodes(tp_size)
        self.k = k
        self.faults: Set[int] = set()
        self.dep = deployment_strategy(num_nodes, nodes_per_tor)
        self._order = np.asarray(self.dep.order, dtype=np.int64)
        p, d, tpd = nodes_per_tor, self.cfg.n_domains, self.cfg.tors_per_domain
        self._chunk_nodes: Dict[Tuple[int, int], List[int]] = {
            (dd, ii): [dd * agg_domain + t * p + ii for t in range(tpd)]
            for dd in range(d) for ii in range(p)}
        self._raw = {key: IncrementalOrchestrator(nodes, self.m, k)
                     for key, nodes in self._chunk_nodes.items()}
        self._aligned = {key: IncrementalOrchestrator(nodes, self.m, k)
                         for key, nodes in self._chunk_nodes.items()}
        self._tor_count = np.zeros(num_nodes // p, dtype=np.int64)
        self._count_cache: Dict[int, int] = {}
        self._mat_cache: Dict[int, Placement] = {}
        self.events_applied = 0
        for u in sorted(faults or ()):
            self.fault(u)
        self.events_applied = 0

    # ------------------------------------------------------------- events

    def _chunk_of(self, node: int) -> Tuple[int, int]:
        return node // self.cfg.agg_domain, node % self.cfg.nodes_per_tor

    def fault(self, node: int) -> None:
        if node in self.faults:
            return
        self.faults.add(node)
        self.events_applied += 1
        self._count_cache.clear()
        self._mat_cache.clear()
        if not (0 <= node < self.cfg.num_nodes):
            return
        self._raw[self._chunk_of(node)].fault(node)
        p = self.cfg.nodes_per_tor
        tor = node // p
        self._tor_count[tor] += 1
        if self._tor_count[tor] == 1:
            d = node // self.cfg.agg_domain
            for i in range(p):
                self._aligned[(d, i)].fault(tor * p + i)

    def repair(self, node: int) -> None:
        if node not in self.faults:
            return
        self.faults.discard(node)
        self.events_applied += 1
        self._count_cache.clear()
        self._mat_cache.clear()
        if not (0 <= node < self.cfg.num_nodes):
            return
        self._raw[self._chunk_of(node)].repair(node)
        p = self.cfg.nodes_per_tor
        tor = node // p
        self._tor_count[tor] -= 1
        if self._tor_count[tor] == 0:
            d = node // self.cfg.agg_domain
            for i in range(p):
                self._aligned[(d, i)].repair(tor * p + i)

    # ------------------------------------------------------------ queries

    def _tiers(self, n_constraints: int) -> Tuple[int, int]:
        p, d = self.cfg.nodes_per_tor, self.cfg.n_domains
        return min(n_constraints, p), max(0, min(n_constraints - p, d))

    def _tier_trackers(self, n_constraints: int):
        n_sub, n_align = self._tiers(n_constraints)
        for (dd, ii), nodes in self._chunk_nodes.items():
            if ii >= n_sub:
                continue
            yield (dd, ii), (self._aligned if dd < n_align
                             else self._raw)[(dd, ii)]

    def _used_or_faulty(self, n_constraints: int) -> np.ndarray:
        mask = np.zeros(self.cfg.num_nodes, dtype=bool)
        mask[[u for u in self.faults if 0 <= u < self.cfg.num_nodes]] = True
        for _, tracker in self._tier_trackers(n_constraints):
            for grp in tracker.placement():
                mask[grp] = True
        return mask

    def capacity_groups(self, n_constraints: int) -> int:
        """Total groups Algorithm 4 yields at this constraint level."""
        cached = self._count_cache.get(n_constraints)
        if cached is not None:
            return cached
        tier = sum(t.capacity_groups()
                   for _, t in self._tier_trackers(n_constraints))
        avail = ~self._used_or_faulty(n_constraints)[self._order]
        residual = int(segment_placed_counts(avail[None], self.k,
                                             self.m)[0]) // self.m
        total = tier + residual
        self._count_cache[n_constraints] = total
        return total

    def orchestrate(self, job_gpus: int) -> Optional[Placement]:
        """Algorithm 5 on the delta-maintained state.

        Equal to ``orchestrate_fat_tree(num_nodes, gpus_per_node,
        nodes_per_tor, faults, tp_size, job_gpus, agg_domain, k)``.
        """
        need = math.ceil(job_gpus / (self.m * self.cfg.gpus_per_node))
        lo, hi = 0, self.cfg.max_constraints
        best = -1
        while lo <= hi:
            mid = (lo + hi) // 2
            if self.capacity_groups(mid) >= need:
                best = mid
                lo = mid + 1
            else:
                hi = mid - 1
        if best < 0:
            return None
        return self._materialize(best)[:need]

    def _materialize(self, n_constraints: int) -> Placement:
        """Algorithm 4's ordered scheme at one constraint level."""
        cached = self._mat_cache.get(n_constraints)
        if cached is not None:
            return cached
        p = self.cfg.nodes_per_tor
        keyed = []
        for (dd, ii), tracker in self._tier_trackers(n_constraints):
            for pos, grp in enumerate(tracker.placement()):
                sig = tuple(u // p for u in grp)
                keyed.append(((dd, sig, pos, ii), grp))
        keyed.sort(key=lambda kv: kv[0])
        placement: Placement = [grp for _, grp in keyed]
        # residual carve through the vectorized stream path (identical to
        # orchestrate_dcn_free over dep.order with used nodes as faults)
        avail = ~self._used_or_faulty(n_constraints)[self._order]
        cols, _, _ = stream_placed_cols(avail[None], self.k, self.m)
        if cols.size:
            nodes = self._order[cols].reshape(-1, self.m)
            placement.extend(nodes.tolist())
        self._mat_cache[n_constraints] = placement
        return placement


__all__ = ["IncrementalFatTreeOrchestrator"]
