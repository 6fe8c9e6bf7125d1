"""Vectorized fat-tree DCN placement kernels (Algorithms 4/5, batched).

The scalar reference path -- ``orchestrate_fat_tree`` running a binary
search over ``placement_fat_tree`` -- costs O(nodes x log constraints) of
Python set manipulation *per snapshot*.  This module re-expresses the whole
pipeline as array programs over a ``(snapshots, nodes)`` fault-mask matrix,
bit-for-bit equal to the scalar placements (pinned by ``tests/test_torch_dcn.py``):

  * :func:`line_carve` -- Algorithm 2's group carving along a node line as
    pure cumulative-scan arithmetic (the placed-node mask of every snapshot
    at once);
  * :func:`batched_fat_tree` -- Algorithm 5: the sub-line x domain chunk
    grid is one reshape of the node axis, constraint tiers become masked
    carves, the binary search is replayed on count vectors, and Algorithm
    4's ``(domain, ToR-signature, position, sub-line)`` ordering is one
    ``np.lexsort``;
  * :func:`batched_greedy` / :func:`batched_dgx_island` -- the paper's
    baselines (Python-``random``-compatible shuffle; static islands);
  * :func:`batched_pair_counts` -- the DP-ring cross-ToR / cross-pod pair
    counts of every snapshot's placement (``traffic_pair_counts``
    vectorized).

The regular-geometry requirement (ToRs do not straddle aggregation domains,
domains tile the cluster) is checked by :meth:`FatTreeConfig.regular`; the
engine falls back to the scalar loop for irregular configs.

A copy of ``repro.dcn.kernel``; its scans take the NumPy ``mask_cumsum`` of
``repro_torch.kernels.prefix_scan.host``.  The device counterpart of
:func:`batched_fat_tree` is ``repro_torch.dcn.torch_backend``.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..core.orchestrator import deployment_strategy
from ..core.reductions import run_segments, segment_carve_counts
from ..kernels.prefix_scan.host import mask_cumsum


@dataclasses.dataclass(frozen=True)
class FatTreeConfig:
    """Static cluster geometry of one fat-tree placement problem."""

    num_nodes: int
    gpus_per_node: int = 4
    nodes_per_tor: int = 8
    agg_domain: int = 64
    k: int = 3

    @property
    def total_gpus(self) -> int:
        return self.num_nodes * self.gpus_per_node

    @property
    def n_domains(self) -> int:
        return self.num_nodes // self.agg_domain if self.agg_domain else 0

    @property
    def tors_per_domain(self) -> int:
        return self.agg_domain // self.nodes_per_tor

    @property
    def max_constraints(self) -> int:
        return self.n_domains + self.nodes_per_tor

    def regular(self) -> bool:
        """True when the batched chunk-grid formulation applies exactly."""
        p, a, n = self.nodes_per_tor, self.agg_domain, self.num_nodes
        return (p > 0 and a > 0 and a % p == 0 and n % a == 0)

    def group_nodes(self, tp_size: int) -> int:
        if tp_size % self.gpus_per_node:
            raise ValueError("tp_size must be a multiple of gpus_per_node")
        return tp_size // self.gpus_per_node

    def need_groups(self, tp_size: int, job_gpus: int) -> int:
        m = self.group_nodes(tp_size)
        return math.ceil(job_gpus / (m * self.gpus_per_node))

    def order(self) -> np.ndarray:
        dep = deployment_strategy(self.num_nodes, self.nodes_per_tor)
        return np.asarray(dep.order, dtype=np.int64)


@dataclasses.dataclass
class BatchedPlacement:
    """Fixed-shape batched placement schemes for ONE (TP, job) cell.

    ``members[s, g, r]`` is the physical node id of rank ``r`` in the
    ``g``-th DP-ring group of snapshot ``s`` (rows of infeasible snapshots
    are ``-1``).  Feasible rows hold exactly ``need`` groups, matching the
    scalar orchestrators' truncation.
    """

    members: np.ndarray        # (S, need, m) int32, -1 where infeasible
    feasible: np.ndarray       # (S,) bool
    n_constraints: np.ndarray  # (S,) int64; satisfied constraints, -1 n/a
    need: int
    m: int

    def placement(self, snapshot: int) -> Optional[List[List[int]]]:
        """Scalar view of one snapshot (None when infeasible)."""
        if not self.feasible[snapshot]:
            return None
        return self.members[snapshot].tolist()


# --------------------------------------------------------------- line carve

def _idiv(a: np.ndarray, q: int) -> np.ndarray:
    """Elementwise floor division, as a shift when ``q`` is a power of two
    (an arithmetic right shift floors negatives too, so the ``-1`` pad is
    preserved)."""
    if q & (q - 1) == 0:
        return a >> (q.bit_length() - 1)
    return a // q


def _imod(a: np.ndarray, q: int) -> np.ndarray:
    """Elementwise modulo of non-negative ints, masked when ``q`` is a
    power of two (integer remainder is a division per element)."""
    if q & (q - 1) == 0:
        return a & (q - 1)
    return a % q


def line_carve(faulty: np.ndarray, k: int, m: int) -> np.ndarray:
    """Placed-node mask of Algorithm 2 along the last axis.

    A run of >= ``k`` consecutive faults splits the line into components;
    each component's healthy nodes are carved into groups of ``m`` in order
    and a node is *placed* iff its group completes inside the component.
    Pure cumulative scans, so it broadcasts over arbitrary leading axes.
    """
    f = np.asarray(faulty, dtype=bool)
    length = f.shape[-1]
    healthy = ~f
    if length == 0:
        return np.zeros(f.shape, dtype=bool)
    zeros = np.zeros(f.shape[:-1] + (1,), dtype=np.int32)
    hc0 = np.concatenate([zeros, mask_cumsum(healthy)], axis=-1)
    before = hc0[..., :length]            # healthy strictly before i
    total = hc0[..., length:]             # (..., 1) healthy on the line
    runk = np.zeros(f.shape, dtype=bool)
    if length >= k:
        fc0 = np.concatenate([zeros, mask_cumsum(f)], axis=-1)
        runk[..., k - 1:] = (fc0[..., k:] - fc0[..., :length - k + 1]) == k
    comp_start = np.maximum.accumulate(np.where(runk, before, 0), axis=-1)
    # reverse cummin on a contiguous copy (accumulate on a flipped view
    # falls off the fast path)
    rev = np.ascontiguousarray(np.where(runk, before, total)[..., ::-1])
    comp_end = np.minimum.accumulate(rev, axis=-1)[..., ::-1]
    rank = before - comp_start
    size = comp_end - comp_start
    return healthy & (rank - _imod(rank, m) + m <= size)


def segment_placed_counts(available: np.ndarray, k: int, m: int) -> np.ndarray:
    """Per-row placed-node counts of :func:`line_carve`, sparse formulation.

    ``available`` is ``~faulty``: a K-hop component is a maximal run of
    available positions whose internal gaps stay < ``k``, and each
    component places ``size // m * m`` nodes -- computable from the
    available-position stream alone (O(available) past one ``nonzero``),
    which beats the dense scans whenever the caller loops (the binary
    search's residual counts, where most nodes are tier-consumed).  Thin
    wrapper over the shared
    :func:`repro_torch.core.reductions.segment_carve_counts`.
    """
    avail = np.asarray(available, dtype=bool)
    return segment_carve_counts(avail, k, m, avail.shape[0])


def stream_placed_cols(available: np.ndarray, k: int, m: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compacted placed-column stream of :func:`line_carve`.

    Returns ``(placed_cols, counts, offsets)``: the column of every placed
    position in carve order (row-major), the per-row group counts, and the
    per-row start offset into ``placed_cols``.  Because Algorithm 2 carves
    sequentially, group ``g`` of row ``s`` is exactly the slice
    ``placed_cols[offsets[s] + g*m : +m]`` -- members materialize as pure
    gathers, no scatters.
    """
    avail = np.asarray(available, dtype=bool)
    snaps = avail.shape[0]
    rows32, cols32, starts, seg_len = run_segments(avail, k)
    if not rows32.size:
        zeros = np.zeros(snaps, dtype=np.int64)
        return np.zeros(0, dtype=np.int32), zeros, zeros
    seg_id = np.repeat(np.arange(len(starts), dtype=np.int32), seg_len)
    idx = np.arange(rows32.size, dtype=np.int32) - starts[seg_id]
    seg_groups = seg_len // m
    placed = idx < (seg_groups * m)[seg_id]
    counts = np.bincount(rows32[starts], weights=seg_groups,
                         minlength=snaps).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts[:-1]) * m])
    return cols32[placed], counts, offsets


def _group_slots(placed: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-position (group id, rank in group) of a placed-node mask.

    Placed nodes along the carve order form exact ``m``-blocks, so the
    exclusive placed-count prefix divmod ``m`` recovers Algorithm 2's
    sequential carving.
    """
    pc = mask_cumsum(placed) - placed
    return _idiv(pc, m), _imod(pc, m)


# ----------------------------------------------------- Algorithm 4/5 batched

def _chunk_views(cfg: FatTreeConfig, masks: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw and ToR-aligned fault masks on the (domain, sub-line, t) grid.

    Node ``d*agg + t*p + i`` sits at ``[d, i, t]``: sub-line ``i``'s chunk
    inside aggregation domain ``d`` is exactly one row of the grid, in HBD
    order.  The aligned view poisons a whole ToR (all p sub-line slots at
    one ``t``) whenever any of its nodes is faulty (Algorithm 4 tier B).
    """
    s = masks.shape[0]
    p, tpd, d = cfg.nodes_per_tor, cfg.tors_per_domain, cfg.n_domains
    grid = masks.reshape(s, d, tpd, p)
    aligned = np.broadcast_to(grid.any(axis=3, keepdims=True), grid.shape)
    # (S, D, Tpd, P) -> (S, D, P, Tpd): carve axis last, contiguous so the
    # cumulative scans stay on the fast path
    return (np.ascontiguousarray(grid.transpose(0, 1, 3, 2)),
            np.ascontiguousarray(aligned.transpose(0, 1, 3, 2)))


class _TierCarves:
    """The n_c-independent half of Algorithm 4, carved once per mask batch.

    The constrained tier mixes the raw and ToR-aligned fault views *per
    domain*, and each chunk's carve only sees its own view -- so carving
    both views up front and selecting per binary-search probe is exact,
    and turns each probe into boolean selects plus one sparse residual
    count instead of three full cumulative-scan passes.
    """

    def __init__(self, cfg: FatTreeConfig, masks: np.ndarray,
                 order: np.ndarray, m: int):
        self.cfg, self.m, self.masks, self.order = cfg, m, masks, order
        # deployment order is sub-line-major: position i*l + d*Tpd + t holds
        # node d*agg + t*p + i, so order-space views are transposes of the
        # chunk grid -- no permutation gathers anywhere in the hot loop
        self._healthy_order = ~masks[:, order]
        raw, aligned = _chunk_views(cfg, masks)
        self.placed_raw = line_carve(raw, cfg.k, m)       # (S, D, P, Tpd)
        self.placed_aligned = line_carve(aligned, cfg.k, m)
        self.count_raw = (self.placed_raw.sum(-1, dtype=np.int64) // m)
        self.count_aligned = (self.placed_aligned.sum(-1, dtype=np.int64)
                              // m)                       # (S, D, P)
        self._d = np.arange(cfg.n_domains)[None, :, None]
        self._i = np.arange(cfg.nodes_per_tor)[None, None, :]

    def _tiers(self, n_c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n_c = np.asarray(n_c, dtype=np.int64)[:, None, None]
        p, d = self.cfg.nodes_per_tor, self.cfg.n_domains
        return np.minimum(n_c, p), np.clip(n_c - p, 0, d)

    def placed(self, n_c: np.ndarray) -> np.ndarray:
        """Tier placed mask at per-snapshot n_c, shape (S, D, P, Tpd)."""
        n_sub, n_align = self._tiers(n_c)
        if n_align.max() <= 0:            # tier-A-only probe: no select
            placed = self.placed_raw
        else:
            placed = np.where((self._d < n_align)[..., None],
                              self.placed_aligned, self.placed_raw)
        return placed & (self._i < n_sub)[..., None]

    def used(self, placed_tier: np.ndarray) -> np.ndarray:
        """Tier-consumed node mask in node-id order, (S, num_nodes)."""
        s = placed_tier.shape[0]
        # (S, D, P, Tpd) -> (S, D, Tpd, P) -> flat node d*agg + t*p + i
        return placed_tier.transpose(0, 1, 3, 2).reshape(s,
                                                         self.cfg.num_nodes)

    def residual_avail(self, placed_tier: np.ndarray) -> np.ndarray:
        """Residual-available mask in deployment order, (S, num_nodes)."""
        s = placed_tier.shape[0]
        used_order = placed_tier.transpose(0, 2, 1, 3).reshape(
            s, self.cfg.num_nodes)
        # placed nodes are healthy, so healthy-and-not-used is one XOR
        return self._healthy_order ^ used_order

    def counts(self, n_c: np.ndarray) -> np.ndarray:
        """Total (tier + residual) group counts at per-snapshot n_c."""
        n_sub, n_align = self._tiers(n_c)
        chunk_counts = np.where(self._d < n_align, self.count_aligned,
                                self.count_raw)
        tier = np.where(self._i < n_sub, chunk_counts, 0).sum(axis=(1, 2))
        res_nodes = segment_placed_counts(
            self.residual_avail(self.placed(n_c)), self.cfg.k, self.m)
        return tier + res_nodes // self.m


def _replay_binary_search(count_fn, high: int, need: int,
                          snapshots: int) -> np.ndarray:
    """Replay Algorithm 5's binary search on count vectors.

    ``count_fn(mid)`` returns the per-snapshot total group count at
    constraint level ``mid`` (a vector).  Visits exactly the mids the
    scalar search visits per snapshot, so the returned best level matches
    ``orchestrate_fat_tree`` even if feasibility were non-monotone.
    """
    lo = np.zeros(snapshots, dtype=np.int64)
    hi = np.full(snapshots, high, dtype=np.int64)
    best = np.full(snapshots, -1, dtype=np.int64)
    active = lo <= hi
    while active.any():
        obs.count("dcn.search_probes")
        mid = (lo + hi) // 2
        feas = active & (count_fn(mid) >= need)
        best = np.where(feas, mid, best)
        lo = np.where(feas, mid + 1, lo)
        hi = np.where(active & ~feas, mid - 1, hi)
        active = lo <= hi
    return best


def batched_fat_tree(masks: np.ndarray, cfg: FatTreeConfig, tp_size: int,
                     job_gpus: int) -> BatchedPlacement:
    """Algorithm 5 over every snapshot of a fault-mask matrix at once.

    Bit-for-bit equal to ``orchestrate_fat_tree(num_nodes, gpus_per_node,
    nodes_per_tor, faults, tp_size, job_gpus, agg_domain, k)`` per row.
    Requires :meth:`FatTreeConfig.regular` geometry (the engine falls back
    to the scalar loop otherwise).
    """
    if not cfg.regular():
        raise ValueError("batched_fat_tree requires regular geometry "
                         "(nodes_per_tor | agg_domain | num_nodes)")
    m = cfg.group_nodes(tp_size)
    need = cfg.need_groups(tp_size, job_gpus)
    masks = np.asarray(masks, dtype=bool)
    s = masks.shape[0]
    order = cfg.order()
    members = np.full((s, need, m), -1, dtype=np.int32)
    if s == 0:
        return BatchedPlacement(members, np.zeros(0, bool),
                                np.full(0, -1, np.int64), need, m)

    with obs.span("dcn.carve", snapshots=s, group_nodes=m):
        carves = _TierCarves(cfg, masks, order, m)
    with obs.span("dcn.binary_search", snapshots=s,
                  max_constraints=cfg.max_constraints):
        best = _replay_binary_search(carves.counts, cfg.max_constraints,
                                     need, s)
    feasible = best >= 0

    # Materialize the placement at the chosen constraint level.
    placed_tier = carves.placed(np.maximum(best, 0))
    res_avail = carves.residual_avail(placed_tier)
    d, p, tpd = cfg.n_domains, cfg.nodes_per_tor, cfg.tors_per_domain
    g_max = tpd // m
    slots = d * p * g_max
    if slots:
        gid, rk = _group_slots(placed_tier, m)
        tier_nodes = np.full(s * slots * m, -1, dtype=np.int32)
        # dense flat scatter: slot layout is (snapshot, domain, sub-line,
        # group); one flatnonzero + two int32 gathers beat the 4-array
        # fancy-index path
        base = (np.arange(d, dtype=np.int32)[:, None, None] * p
                + np.arange(p, dtype=np.int32)[None, :, None]) * (g_max * m)
        target = (np.arange(s, dtype=np.int32)[:, None, None, None]
                  * np.int32(slots * m) + base[None] + gid * m + rk)
        node_const = (np.arange(d, dtype=np.int32)[:, None, None]
                      * cfg.agg_domain
                      + np.arange(tpd, dtype=np.int32)[None, None, :] * p
                      + np.arange(p, dtype=np.int32)[None, :, None])
        nz = np.flatnonzero(placed_tier)
        tier_nodes[target.reshape(-1)[nz]] = np.broadcast_to(
            node_const[None], placed_tier.shape).reshape(-1)[nz]
        tier_nodes = tier_nodes.reshape(s, slots, m)
        valid = tier_nodes[:, :, 0] >= 0
        # Algorithm 4 DP-ring order: (domain, ToR signature, position,
        # sub-line); invalid slots sort last within their snapshot.  The
        # lexicographic fields are bit-packed into as few int64 words as
        # fit, so the sort runs on 2-3 keys instead of m+3.
        n_tors = cfg.num_nodes // p
        sig = np.where(tier_nodes >= 0, _idiv(tier_nodes, p),
                       np.int32(n_tors))
        dom_k = np.where(
            valid, np.arange(d, dtype=np.int32).repeat(p * g_max)[None, :],
            np.int32(d))
        pos_k = np.broadcast_to(
            np.tile(np.arange(g_max, dtype=np.int32), d * p)[None, :],
            valid.shape)
        idx_k = np.broadcast_to(
            np.tile(np.arange(p, dtype=np.int32).repeat(g_max), d)[None, :],
            valid.shape)
        fields = ([(dom_k, (d + 1).bit_length())]
                  + [(sig[:, :, r], (n_tors + 1).bit_length())
                     for r in range(m)]
                  + [(pos_k, max(g_max, 1).bit_length()),
                     (idx_k, p.bit_length())])
        words: List[np.ndarray] = []
        bits = 64
        for arr, nb in fields:            # most-significant field first
            if bits + nb > 63:
                words.append(arr.astype(np.int64))
                bits = nb
            else:
                words[-1] = (words[-1] << nb) | arr
                bits += nb
        snap_k = np.broadcast_to(np.arange(s, dtype=np.int64)[:, None],
                                 valid.shape)
        keys = tuple(w.ravel() for w in reversed(words)) + (snap_k.ravel(),)
        local = (np.lexsort(keys).reshape(s, slots)
                 - np.arange(s)[:, None] * slots)
        # only the first min(need, slots) ring positions are ever read
        local = local[:, :min(need, slots)]
        tier_sorted = np.take_along_axis(tier_nodes, local[:, :, None],
                                         axis=1)
        tier_count = valid.sum(axis=1, dtype=np.int64)
    else:
        tier_sorted = np.zeros((s, 0, m), dtype=np.int32)
        tier_count = np.zeros(s, dtype=np.int64)

    # Residual members gather straight from the compacted placed stream
    # (group g of row s = placed_cols[offsets[s] + g*m : +m]); the ring
    # order is tier groups first, then residual carve order.
    res_cols, _, res_off = stream_placed_cols(res_avail, cfg.k, m)
    node_stream = order.astype(np.int32)[res_cols]
    j = np.arange(need)[None, :]
    if slots:
        tgather = np.broadcast_to(
            np.minimum(j, tier_sorted.shape[1] - 1), (s, need))
        tier_members = np.take_along_axis(tier_sorted,
                                          tgather[:, :, None], axis=1)
    else:
        tier_members = np.full((s, need, m), -1, dtype=np.int32)
    if node_stream.size:
        ridx = (res_off[:, None, None]
                + (j[:, :, None] - tier_count[:, None, None]) * m
                + np.arange(m)[None, None, :])
        ridx = np.clip(ridx, 0, node_stream.size - 1)
        res_members = node_stream[ridx]
    else:
        res_members = np.full((s, need, m), -1, dtype=np.int32)
    members = np.where((j < tier_count[:, None])[:, :, None],
                       tier_members, res_members).astype(np.int32)
    members[~feasible] = -1
    return BatchedPlacement(members, feasible,
                            np.where(feasible, best, -1), need, m)


# ------------------------------------------------------------- baselines

_SHUFFLE_CACHE: Dict[Tuple[int, int], np.ndarray] = {}


def _shuffle_perm(count: int, seed: int) -> np.ndarray:
    """The exact permutation ``random.Random(seed).shuffle`` applies to a
    list of ``count`` elements (depends only on the length and seed)."""
    perm = _SHUFFLE_CACHE.get((count, seed))
    if perm is None:
        idx = list(range(count))
        random.Random(seed).shuffle(idx)
        perm = np.asarray(idx, dtype=np.int64)
        _SHUFFLE_CACHE[(count, seed)] = perm
    return perm


def batched_greedy(masks: np.ndarray, cfg: FatTreeConfig, tp_size: int,
                   job_gpus: int, seed: int = 0,
                   order: Optional[np.ndarray] = None) -> BatchedPlacement:
    """``greedy_baseline`` over every snapshot: K-hop carve along the HBD
    wiring order, then the paper's random group-to-rank assignment."""
    m = cfg.group_nodes(tp_size)
    need = cfg.need_groups(tp_size, job_gpus)
    masks = np.asarray(masks, dtype=bool)
    s = masks.shape[0]
    order = (np.arange(cfg.num_nodes, dtype=np.int64) if order is None
             else np.asarray(order, dtype=np.int64))
    placed_cols, counts, offsets = stream_placed_cols(~masks[:, order],
                                                      cfg.k, m)
    node_stream = order.astype(np.int32)[placed_cols]
    feasible = counts >= need
    members = np.full((s, need, m), -1, dtype=np.int32)
    ranks = np.arange(m, dtype=np.int64)[None, None, :]
    # the shuffle permutation depends only on (group count, seed): gather
    # all rows sharing a count in one shot
    for cnt in np.unique(counts[feasible]):
        rows = np.nonzero(feasible & (counts == cnt))[0]
        perm = _shuffle_perm(int(cnt), seed)[:need]
        base = offsets[rows, None, None] + (perm * m)[None, :, None]
        members[rows] = node_stream[base + ranks]
    return BatchedPlacement(members, feasible, np.full(s, -1, np.int64),
                            need, m)


def dgx_island_placement(num_nodes: int, faults, m: int,
                         need: int) -> Optional[List[List[int]]]:
    """Scalar reference for the DGX-island baseline: static contiguous
    islands of ``m`` nodes, scheduled in node-id order; a fault withholds
    its whole island (no optical re-splicing), DP ranks follow island
    order.  Returns the first ``need`` healthy islands or None."""
    blocks = []
    for b in range(num_nodes // m):
        lo = b * m
        if not any(u in faults for u in range(lo, lo + m)):
            blocks.append(list(range(lo, lo + m)))
            if len(blocks) == need:
                return blocks
    return None


def batched_dgx_island(masks: np.ndarray, cfg: FatTreeConfig, tp_size: int,
                       job_gpus: int) -> BatchedPlacement:
    """:func:`dgx_island_placement` over every snapshot."""
    m = cfg.group_nodes(tp_size)
    need = cfg.need_groups(tp_size, job_gpus)
    masks = np.asarray(masks, dtype=bool)
    s = masks.shape[0]
    blocks = cfg.num_nodes // m
    healthy = ~masks[:, :blocks * m].reshape(s, blocks, m).any(axis=2)
    feasible = healthy.sum(axis=1, dtype=np.int64) >= need
    # stable argsort floats healthy islands to the front in id order
    first = np.argsort(~healthy, axis=1, kind="stable")[:, :need]
    members = first[:, :, None] * m + np.arange(m)[None, None, :]
    members = np.where(feasible[:, None, None], members, -1)
    return BatchedPlacement(members.astype(np.int32), feasible,
                            np.full(s, -1, np.int64), need, m)


# ------------------------------------------------------------ traffic counts

def batched_pair_counts(bp: BatchedPlacement, nodes_per_tor: int,
                        agg_domain: int = 0) -> Dict[str, np.ndarray]:
    """``traffic_pair_counts`` vectorized over a :class:`BatchedPlacement`.

    Returns int64 vectors (snapshots,) of DP-ring pair counts; infeasible
    rows are all zero, matching the scalar empty-placement result.
    """
    members, feasible = bp.members, bp.feasible
    s, g_count, m = members.shape
    zeros = np.zeros(s, dtype=np.int64)
    if g_count <= 1:
        return {"groups": np.where(feasible, g_count, 0).astype(np.int64),
                "dp_pairs": zeros, "crossing_pairs": zeros,
                "crossing_pod_pairs": zeros}
    def _ring_crossings(ids: np.ndarray) -> np.ndarray:
        inner = (ids[:, :-1] != ids[:, 1:]).sum(axis=(1, 2), dtype=np.int64)
        wrap = (ids[:, -1] != ids[:, 0]).sum(axis=1, dtype=np.int64)
        return inner + wrap

    crossing = _ring_crossings(_idiv(members, nodes_per_tor))
    crossing_pod = _ring_crossings(_idiv(members, agg_domain)) if agg_domain \
        else zeros
    return {"groups": np.where(feasible, g_count, 0).astype(np.int64),
            "dp_pairs": np.where(feasible, g_count * m, 0).astype(np.int64),
            "crossing_pairs": np.where(feasible, crossing, 0),
            "crossing_pod_pairs": np.where(feasible, crossing_pod, 0)}
