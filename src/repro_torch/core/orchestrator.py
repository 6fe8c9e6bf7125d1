"""HBD orchestration (paper §4.3 + Appendix D): the part the sweep needs.

Holds only :func:`healthy_components` of ``repro.core.orchestrator``, the
K-hop component rule that ``hbd_models.InfiniteHBDModel.evaluate`` (the
scalar reference) uses.  The rest of the module -- Algorithms 2-5, the
greedy baseline, cross-ToR traffic and the incremental orchestrator --
waits for the DCN and churn slices of the port.
"""

from __future__ import annotations

from typing import List, Sequence, Set


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


__all__ = ["healthy_components"]
