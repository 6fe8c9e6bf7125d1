"""HBD-DCN orchestration (paper §4.3 + Appendix D).

Implements, faithfully to the pseudocode:

  * ``orchestrate_dcn_free``   -- Algorithm 2 (DFS over the healthy K-hop
                                  subgraph, pop TP groups per component).
  * ``deployment_strategy``    -- Algorithm 3 (p parallel sub-lines; the HBD
                                  line visits one node per ToR so TP runs
                                  *across* ToRs while DP/CP aligns *within*).
  * ``placement_fat_tree``     -- Algorithm 4 (constraint tiers: sub-line
                                  isolation, then ToR alignment).
  * ``orchestrate_fat_tree``   -- Algorithm 5 (binary search over the number
                                  of satisfied constraints; monotonic).
  * ``greedy_baseline``        -- the paper's §6.4 baseline (first feasible
                                  grouping of randomly ordered nodes).
  * ``cross_tor_traffic``      -- volume-weighted cross-ToR share used for
                                  the Fig. 17 reproduction.

The placement scheme is an *ordered* list of TP groups: consecutive groups
are DP/CP ring neighbors.  ``placement_fat_tree`` therefore emits groups
domain-major / position-major / sub-line-minor, so the DP ring first visits
the p rank-aligned groups under the same ToRs (intra-ToR traffic) before
hopping to the next ToR block -- only ~1/p of DP hops cross a ToR even at
full occupancy, and none do when alignment survives faults.

A copy of ``repro.core.orchestrator``.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

Placement = List[List[int]]  # list of TP groups, each an ordered node list


# --------------------------------------------------------------------------
# Algorithm 2: DCN-free orchestration
# --------------------------------------------------------------------------

def healthy_components(order: Sequence[int], faults: Set[int], k: int) -> List[List[int]]:
    """Connected components of the healthy K-hop subgraph along ``order``.

    ``order`` is the node sequence as seen by the HBD (adjacent elements are
    HBD neighbors).  A gap of g consecutive faulty nodes splits the line iff
    g >= k (backup links reach at most k hops past the primary neighbor).
    """
    comps: List[List[int]] = []
    cur: List[int] = []
    gap = 0
    for u in order:
        if u in faults:
            gap += 1
            if gap >= k and cur:
                comps.append(cur)
                cur = []
            continue
        cur.append(u)
        gap = 0
    if cur:
        comps.append(cur)
    return comps


def orchestrate_dcn_free(order: Sequence[int], faults: Set[int], m: int,
                         k: int = 3) -> Placement:
    """Algorithm 2: maximize GPU utilization ignoring DCN topology."""
    if m < 1:
        raise ValueError("TP group must span at least one node")
    placement: Placement = []
    for comp in healthy_components(order, faults, k):
        while len(comp) >= m:
            placement.append(comp[:m])
            comp = comp[m:]
    return placement


# --------------------------------------------------------------------------
# Incremental orchestration: delta updates on single fault/repair events
# --------------------------------------------------------------------------

class _Component:
    """One healthy K-hop component: sorted healthy positions + carved groups.

    ``groups`` holds only *complete* TP groups (physical node ids), exactly
    as Algorithm 2 carves them -- the sub-``m`` remainder is implicit.
    """

    __slots__ = ("healthy", "groups")

    def __init__(self, healthy: List[int], groups: Placement):
        self.healthy = healthy
        self.groups = groups

    @property
    def start(self) -> int:
        return self.healthy[0]

    @property
    def end(self) -> int:
        return self.healthy[-1]


class IncrementalOrchestrator:
    """Algorithm 2 with delta updates on single fault/repair events.

    Maintains the healthy K-hop component structure along a fixed HBD
    ``order`` and the per-component TP-group carving.  Because Algorithm 2
    carves groups sequentially, an event at healthy-index ``i`` of a
    component leaves groups ``< i // m`` untouched: a fault only splits or
    shrinks its own component and re-carves the suffix; a repair only
    extends or merges the components adjacent to its gap.  The per-event
    cost is bounded by the affected suffix (C-speed list slicing), not by a
    full O(cluster) Python re-scan.

    ``placement()`` is guaranteed to equal
    ``orchestrate_dcn_free(order, faults, m, k)`` after any event sequence
    (the property test in ``tests/test_sim_engine.py`` enforces this).
    """

    def __init__(self, order: Sequence[int], m: int, k: int = 3,
                 faults: Optional[Set[int]] = None):
        if m < 1:
            raise ValueError("TP group must span at least one node")
        self.order = list(order)
        self.m = m
        self.k = k
        self.pos_of = {u: i for i, u in enumerate(self.order)}
        self.faults: Set[int] = set(faults or ())
        self._fault_pos = {self.pos_of[u] for u in self.faults
                           if u in self.pos_of}
        self._comps: List[_Component] = [
            _Component([self.pos_of[u] for u in nodes], self._carve(
                [self.pos_of[u] for u in nodes]))
            for nodes in healthy_components(self.order, self.faults, self.k)]
        self.events_applied = 0

    # ------------------------------------------------------------ queries

    def placement(self) -> Placement:
        return [grp for comp in self._comps for grp in comp.groups]

    def capacity_groups(self) -> int:
        return sum(len(comp.groups) for comp in self._comps)

    def capacity_nodes(self) -> int:
        return self.capacity_groups() * self.m

    # ------------------------------------------------------------- events

    def fault(self, node: int) -> None:
        if node in self.faults or node not in self.pos_of:
            self.faults.add(node)
            return
        self.faults.add(node)
        p = self.pos_of[node]
        self._fault_pos.add(p)
        self.events_applied += 1
        ci = self._comp_index_containing(p)
        if ci is None:
            return
        comp = self._comps[ci]
        h = comp.healthy
        idx = bisect.bisect_left(h, p)
        # contiguous faulty run now containing p
        lo = p - 1
        while lo in self._fault_pos:
            lo -= 1
        hi = p + 1
        while hi in self._fault_pos:
            hi += 1
        if lo < comp.start:
            # run touches the left edge: component shrinks from the left
            # (the widened inter-component gap was already >= K); every
            # group shifts, so carve afresh
            del h[0]
            if not h:
                self._comps.pop(ci)
            else:
                comp.groups = self._carve(h)
        elif hi > comp.end:
            # run touches the right edge: drop the tail node, at most the
            # last group changes
            del h[-1]
            self._recarve_suffix(comp, len(h))
        elif hi - lo - 1 >= self.k:
            # the gap reached K: split around the run
            left = _Component(h[:idx], comp.groups[:idx // self.m])
            right_h = h[idx + 1:]
            right = _Component(right_h, self._carve(right_h))
            self._comps[ci:ci + 1] = [c for c in (left, right) if c.healthy]
        else:
            # interior removal inside a still-bridged gap
            del h[idx]
            self._recarve_suffix(comp, idx)

    def repair(self, node: int) -> None:
        if node not in self.faults:
            return
        self.faults.discard(node)
        if node not in self.pos_of:
            return
        p = self.pos_of[node]
        self._fault_pos.discard(p)
        self.events_applied += 1
        ci = self._comp_index_containing(p)
        if ci is not None:
            # p sat in a bridged (< K) gap inside one component: insert
            comp = self._comps[ci]
            idx = bisect.bisect_left(comp.healthy, p)
            comp.healthy.insert(idx, p)
            self._recarve_suffix(comp, idx)
            return
        # p lies in an inter-component gap (or beyond the ends); the gaps on
        # each side of p are entirely faulty, so merging is a pure gap-length
        # check against K
        i = bisect.bisect_right(self._comps, p,
                                key=lambda c: c.healthy[0]) - 1
        # comps[i] has start <= p and (not containing, checked above) end < p
        left = i if i >= 0 else None
        right = i + 1 if i + 1 < len(self._comps) else None
        insert_at = i + 1
        lcomp = self._comps[left] if left is not None else None
        rcomp = self._comps[right] if right is not None else None
        merge_l = lcomp is not None and (p - lcomp.end - 1) < self.k
        merge_r = rcomp is not None and (rcomp.start - p - 1) < self.k
        if merge_l:
            keep = len(lcomp.healthy) // self.m      # complete groups survive
            healthy = lcomp.healthy + [p] + (rcomp.healthy if merge_r else [])
            groups = lcomp.groups[:keep] + self._carve(healthy, keep * self.m)
            merged = _Component(healthy, groups)
            hi_i = right + 1 if merge_r else left + 1
            self._comps[left:hi_i] = [merged]
        elif merge_r:
            healthy = [p] + rcomp.healthy
            self._comps[right] = _Component(healthy, self._carve(healthy))
        else:
            self._comps.insert(insert_at,
                               _Component([p], self._carve([p])))

    # ----------------------------------------------------------- internals

    def _comp_index_containing(self, p: int) -> Optional[int]:
        # spans are disjoint and _comps stays sorted by start
        i = bisect.bisect_right(self._comps, p,
                                key=lambda c: c.healthy[0]) - 1
        if i >= 0 and self._comps[i].healthy[-1] >= p:
            return i
        return None

    def _carve(self, positions: Sequence[int], from_idx: int = 0) -> Placement:
        """Complete m-groups of ``positions[from_idx:]`` as physical ids."""
        order, m = self.order, self.m
        return [[order[q] for q in positions[j:j + m]]
                for j in range(from_idx, len(positions) - m + 1, m)]

    def _recarve_suffix(self, comp: _Component, idx: int) -> None:
        """Re-carve groups from the one containing healthy-index ``idx``."""
        g0 = idx // self.m
        del comp.groups[g0:]
        comp.groups.extend(self._carve(comp.healthy, g0 * self.m))
        if not comp.healthy:
            self._comps.remove(comp)


# --------------------------------------------------------------------------
# Algorithm 3: deployment strategy
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Deployment:
    """Physical deployment: node id <-> HBD order <-> ToR."""

    order: Tuple[int, ...]        # S_deploy: HBD-adjacent node sequence
    sublines: Tuple[Tuple[int, ...], ...]
    nodes_per_tor: int            # p
    num_nodes: int

    def tor(self, node: int) -> int:
        return node // self.nodes_per_tor


def deployment_strategy(num_nodes: int, nodes_per_tor: int) -> Deployment:
    """Algorithm 3: sub-line i = nodes [i, i+p, i+2p, ...].

    Consecutive HBD neighbors within a sub-line sit at the *same index under
    consecutive ToRs*, so a TP group spans m ToRs while rank-aligned TP
    groups in the other p-1 sub-lines share those ToRs -- keeping DP/CP
    traffic intra-ToR.
    """
    p = nodes_per_tor
    l = num_nodes // p
    sublines = tuple(tuple(i + j * p for j in range(l)) for i in range(p))
    order = tuple(x for sub in sublines for x in sub)
    return Deployment(order=order, sublines=sublines,
                      nodes_per_tor=p, num_nodes=num_nodes)


# --------------------------------------------------------------------------
# Algorithm 4: placement under Fat-Tree constraints
# --------------------------------------------------------------------------

def placement_fat_tree(dep: Deployment, n_constraints: int, faults: Set[int],
                       m: int, agg_domain: int, k: int = 3) -> Placement:
    """Algorithm 4.

    Constraints are consumed in two tiers (Algorithm 4's ``n_subline`` /
    ``n_align`` split):

      tier A (first ``min(n_constraints, p)``): *sub-line isolation* -- that
        many sub-lines are placed independently and split at
        Aggregation-Switch domain borders, so no TP group spans two domains.
      tier B (remaining constraints): *TP-group alignment* -- within that
        many aggregation domains, a fault anywhere under a ToR poisons the
        whole ToR (all p co-located nodes), so every sub-line shifts
        identically and rank alignment survives.

    Whatever capacity the constraints exclude is recovered by an
    unconstrained Algorithm-2 pass over the residual nodes.
    """
    p = dep.nodes_per_tor
    n_maxsubline = len(dep.sublines)
    n_domain = dep.num_nodes // agg_domain if agg_domain else 0
    n_align = max(0, min(n_constraints - n_maxsubline, n_domain))
    n_subline = min(n_maxsubline, n_constraints)

    # Tier B: expand faults to whole ToRs inside the aligned domains.
    eff_faults = set(faults)
    for dom in range(n_align):
        lo, hi = dom * agg_domain, (dom + 1) * agg_domain
        for node in range(lo, min(hi, dep.num_nodes)):
            if node in faults:
                tor = node // p
                eff_faults.update(range(tor * p, min((tor + 1) * p, dep.num_nodes)))

    # (domain, position-in-domain, subline) -> group; ordering key later.
    keyed: List[Tuple[Tuple[int, int, int], List[int]]] = []
    used: Set[int] = set()

    for idx in range(n_subline):
        sub = dep.sublines[idx]
        # split the sub-line wherever the aggregation domain changes
        chunks: Dict[int, List[int]] = {}
        for u in sub:
            dom = (u // agg_domain) if agg_domain else 0
            chunks.setdefault(dom, []).append(u)
        for dom, chunk in chunks.items():
            for pos, grp in enumerate(orchestrate_dcn_free(chunk, eff_faults, m, k)):
                keyed.append(((dom, pos, idx), grp))
                used.update(grp)

    # DP ring order: domain-major, then cluster by the groups' actual ToR
    # signature (beyond-paper: fault-shifted sub-lines re-align with other
    # equally-shifted groups instead of breaking every neighboring pair),
    # position-major, sub-line-minor as the tie-break.
    def order_key(kv):
        (dom, pos, idx), grp = kv
        sig = tuple(u // p for u in grp)
        return (dom, sig, pos, idx)

    keyed.sort(key=order_key)
    placement: Placement = [grp for _, grp in keyed]

    # Residual: unconstrained placement over everything not yet used.  Used
    # nodes act as faults so groups never jump a >K gap of consumed nodes.
    res_faults = set(faults) | used
    for grp in orchestrate_dcn_free(dep.order, res_faults, m, k):
        placement.append(grp)
    return placement


# --------------------------------------------------------------------------
# Algorithm 5: binary search orchestration
# --------------------------------------------------------------------------

def orchestrate_fat_tree(num_nodes: int, gpus_per_node: int, nodes_per_tor: int,
                         faults: Set[int], tp_size: int, job_gpus: int,
                         agg_domain: int, k: int = 3) -> Optional[Placement]:
    """Algorithm 5: max constraints whose placement still satisfies the job."""
    if tp_size % gpus_per_node:
        raise ValueError("tp_size must be a multiple of gpus_per_node")
    m = tp_size // gpus_per_node
    dep = deployment_strategy(num_nodes, nodes_per_tor)
    n_domain = num_nodes // agg_domain if agg_domain else 0
    lo, hi = 0, n_domain + len(dep.sublines)
    best: Optional[Placement] = None
    while lo <= hi:
        mid = (lo + hi) // 2
        scheme = placement_fat_tree(dep, mid, faults, m, agg_domain, k)
        if len(scheme) * m * gpus_per_node >= job_gpus:
            best = scheme
            lo = mid + 1
        else:
            hi = mid - 1
    if best is None:
        return None
    need = math.ceil(job_gpus / (m * gpus_per_node))
    return best[:need]


# --------------------------------------------------------------------------
# Baseline (paper §6.4): greedy random placement
# --------------------------------------------------------------------------

def greedy_baseline(num_nodes: int, gpus_per_node: int, faults: Set[int],
                    tp_size: int, job_gpus: int, k: int = 3,
                    seed: int = 0,
                    order: Optional[Sequence[int]] = None) -> Optional[Placement]:
    """Randomly order the cluster, take the first feasible grouping.

    TP groups must still be K-hop rings (physically realizable), so groups
    are carved from healthy runs of the *HBD wiring* order, but the
    assignment of groups to job ranks is random -- which is what spills DP
    across ToRs.
    """
    m = tp_size // gpus_per_node
    groups = orchestrate_dcn_free(order if order is not None
                                  else list(range(num_nodes)), faults, m, k)
    need = math.ceil(job_gpus / (m * gpus_per_node))
    if len(groups) < need:
        return None
    rng = random.Random(seed)
    rng.shuffle(groups)
    return groups[:need]


# --------------------------------------------------------------------------
# Cross-ToR / cross-pod traffic accounting (Fig. 17)
# --------------------------------------------------------------------------

def traffic_pair_counts(placement: Placement, nodes_per_tor: int,
                        agg_domain: int = 0) -> Dict[str, int]:
    """Integer DP-ring pair counts of one placement scheme.

    DP/CP traffic rides the DCN between rank-aligned nodes of consecutive
    TP groups; the DP ring closes (last group talks back to the first)
    whenever more than one group exists.  Returns ``groups``, ``m`` (nodes
    per group), ``dp_pairs``, ``crossing_pairs`` (pairs whose endpoints sit
    under different ToRs) and ``crossing_pod_pairs`` (different aggregation
    domains; 0 when ``agg_domain`` is 0).  Shared with the batched
    ``repro.dcn`` kernels, which compute the same counts vectorized.
    """
    if not placement:
        return {"groups": 0, "m": 0, "dp_pairs": 0, "crossing_pairs": 0,
                "crossing_pod_pairs": 0}
    arr = np.asarray(placement, dtype=np.int64)
    g_count, m = arr.shape
    crossing = crossing_pod = pairs = 0
    if g_count > 1:
        tor = arr // nodes_per_tor
        crossing = int((tor != np.roll(tor, -1, axis=0)).sum())
        pairs = g_count * m
        if agg_domain:
            pod = arr // agg_domain
            crossing_pod = int((pod != np.roll(pod, -1, axis=0)).sum())
    return {"groups": int(g_count), "m": int(m), "dp_pairs": pairs,
            "crossing_pairs": crossing, "crossing_pod_pairs": crossing_pod}


def traffic_volume_shares(dp_pairs, crossing_pairs, crossing_pod_pairs,
                          tp_members, dp_bytes: float = 1.0,
                          tp_bytes: float = 9.0) -> Dict[str, np.ndarray]:
    """Volume-weighted DCN shares from integer pair counts.

    Works elementwise on scalars or arrays (the batched engine feeds whole
    grids through the identical float64 expressions, so shares agree
    bit-for-bit with the scalar path).
    """
    dp_vol = np.asarray(dp_pairs, dtype=np.float64) * dp_bytes
    cross_vol = np.asarray(crossing_pairs, dtype=np.float64) * dp_bytes
    pod_vol = np.asarray(crossing_pod_pairs, dtype=np.float64) * dp_bytes
    tp_vol = np.asarray(tp_members, dtype=np.float64) * tp_bytes
    total = dp_vol + tp_vol
    pairs = np.asarray(dp_pairs, dtype=np.float64)

    def _div(num, den):
        num, den = np.broadcast_arrays(np.asarray(num, dtype=np.float64), den)
        return np.divide(num, den, out=np.zeros(num.shape), where=den != 0)

    return {"cross_tor_share": _div(cross_vol, total),
            "cross_pod_share": _div(pod_vol, total),
            "dp_cross_share": _div(crossing_pairs, pairs)}


def cross_tor_traffic(placement: Placement, nodes_per_tor: int,
                      dp_bytes: float = 1.0, tp_bytes: float = 9.0,
                      agg_domain: int = 0) -> Dict[str, float]:
    """Volume-weighted cross-ToR (and optionally cross-pod) share.

    TP traffic always stays in the HBD (never touches the DCN).  DP/CP/PP
    traffic rides the DCN between rank-aligned nodes of consecutive TP groups
    in the DP ring, which closes whenever the placement holds more than one
    group; each such node pair exchanges ``dp_bytes`` while each TP group
    internally moves ``tp_bytes`` per member.  The defaults (9:1) match the
    Megatron-style volume ratio that puts the paper's baseline plateau near
    10%; ``repro.dcn.traffic.dp_tp_bytes`` recomputes both from an actual
    model config.  With ``agg_domain`` set, ``cross_pod_share`` accounts the
    pairs that additionally cross an aggregation-switch domain.
    """
    c = traffic_pair_counts(placement, nodes_per_tor, agg_domain)
    s = traffic_volume_shares(c["dp_pairs"], c["crossing_pairs"],
                              c["crossing_pod_pairs"], c["groups"] * c["m"],
                              dp_bytes, tp_bytes)
    return {
        "cross_tor_share": float(s["cross_tor_share"]),
        "cross_pod_share": float(s["cross_pod_share"]),
        "dp_cross_share": float(s["dp_cross_share"]),
        "dp_pairs": c["dp_pairs"],
        "crossing_pairs": c["crossing_pairs"],
        "crossing_pod_pairs": c["crossing_pod_pairs"],
    }
