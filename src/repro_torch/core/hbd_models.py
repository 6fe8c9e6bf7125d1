"""Comparative HBD architecture models (paper §6.2, Table 1).

A copy of ``repro.core.hbd_models``: the scalar references and the batched
NumPy kernels, which are the port's ``backend="numpy"`` and give the host
totals of the torch backend.

Each model answers: given a set of faulty nodes and a TP size, how many
healthy GPUs can actually be placed into TP groups, and how many are wasted
(fragmentation, topology disconnection, spare reservation, coarse-granularity
scheduling)?  The GPU waste ratio is

    waste_ratio = (healthy_gpus - placed_gpus) / total_gpus

exactly as in §2.1 (faulty GPUs are accounted separately).

Architectures:

  * ``BigSwitch``      -- ideal single switch over the whole cluster.
  * ``InfiniteHBDModel`` -- K-hop ring over the whole cluster (ours).
  * ``NVLModel``       -- switch-centric HBD islands of ``hbd_gpus`` each;
                          NVL-36/72 reserve 1/9 of GPUs as hot spares (the
                          paper's "11% backup overhead"), NVL-576 does not.
  * ``TPUv4Model``     -- 4^3 cubes behind central OCSes; scheduling is
                          cube-granular, so a fault poisons its 64-TPU cube.
  * ``SiPRingModel``   -- static rings of exactly TP size; one fault breaks
                          the ring into a line, unusable for ring TP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Set

import numpy as np

from .orchestrator import healthy_components


@dataclasses.dataclass
class WasteResult:
    total_gpus: int
    faulty_gpus: int
    placed_gpus: int

    @property
    def healthy_gpus(self) -> int:
        return self.total_gpus - self.faulty_gpus

    @property
    def wasted_gpus(self) -> int:
        return self.healthy_gpus - self.placed_gpus

    @property
    def waste_ratio(self) -> float:
        return self.wasted_gpus / self.total_gpus if self.total_gpus else 0.0

    @property
    def usable_groups(self) -> int:
        return self.placed_gpus  # caller divides by tp_size


@dataclasses.dataclass
class BatchedWasteResult:
    """Vectorized :class:`WasteResult` over a ``(snapshots, tp_sizes)`` grid.

    ``total_gpus`` is per TP size because granular models (SiP-Ring) round the
    cluster down to a whole number of rings, so the modeled capacity itself
    depends on TP.  ``faulty_gpus`` is per snapshot *and* TP for the same
    reason (faults on unmodeled tail nodes don't count).
    """

    tp_sizes: np.ndarray     # (T,) int
    total_gpus: np.ndarray   # (T,) int
    faulty_gpus: np.ndarray  # (S, T) int
    placed_gpus: np.ndarray  # (S, T) int

    @property
    def healthy_gpus(self) -> np.ndarray:
        return self.total_gpus[None, :] - self.faulty_gpus

    @property
    def wasted_gpus(self) -> np.ndarray:
        return self.healthy_gpus - self.placed_gpus

    @property
    def waste_ratio(self) -> np.ndarray:
        total = self.total_gpus[None, :]
        return np.divide(self.wasted_gpus, total,
                         out=np.zeros(self.placed_gpus.shape),
                         where=total != 0)

    def result(self, snapshot: int, tp_index: int = 0) -> WasteResult:
        """Scalar view of one grid cell (for spot checks / logging)."""
        return WasteResult(int(self.total_gpus[tp_index]),
                           int(self.faulty_gpus[snapshot, tp_index]),
                           int(self.placed_gpus[snapshot, tp_index]))


class HBDModel:
    """Base: a cluster of ``num_nodes`` nodes x ``gpus_per_node`` GPUs.

    Two evaluation paths, guaranteed to agree bit-for-bit:

      * ``evaluate(faults, tp)``            -- one snapshot (reference path);
      * ``evaluate_batch(masks, tp_sizes)`` -- a ``(snapshots x tp_sizes)``
        grid in vectorized NumPy; subclasses override ``_batch_eval`` with
        closed-form kernels, the base class falls back to looping
        ``evaluate``.  Kernels are pure array-in/array-out; the torch
        backend (``repro_torch.sim.torch_backend``) re-expresses them batched
        over snapshot rows on the device.
    """

    name = "base"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4):
        self.num_nodes = num_nodes
        self.gpus_per_node = gpus_per_node
        self.total_gpus = num_nodes * gpus_per_node

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        raise NotImplementedError

    def static_key(self) -> tuple:
        """Hashable static identity of the model's kernel configuration --
        the device backend's cache key.  Subclasses contribute their extra
        constructor knobs via ``_static_config`` so two instances compare
        equal exactly when their compiled kernels would."""
        return ((type(self).__name__, self.num_nodes, self.gpus_per_node)
                + self._static_config())

    def _static_config(self) -> tuple:
        return ()

    def evaluate_batch(self, fault_masks: np.ndarray,
                       tp_sizes: Sequence[int]) -> BatchedWasteResult:
        """Evaluate every (snapshot, TP size) pair of the grid.

        ``fault_masks`` is a ``(snapshots, nodes)`` bool matrix; columns
        beyond ``num_nodes`` are ignored and missing columns read healthy,
        mirroring the scalar callers' ``u < model.num_nodes`` clipping.
        """
        masks = self._clip_masks(fault_masks)
        tps = np.asarray(list(tp_sizes), dtype=np.int64)
        return self._batch_eval(masks, tps)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        snaps, tcount = masks.shape[0], len(tps)
        total = np.zeros(tcount, dtype=np.int64)
        faulty = np.zeros((snaps, tcount), dtype=np.int64)
        placed = np.zeros((snaps, tcount), dtype=np.int64)
        fault_sets = [set(np.nonzero(row)[0].tolist()) for row in masks]
        for ti, tp in enumerate(tps):
            for si, faults in enumerate(fault_sets):
                r = self.evaluate(faults, int(tp))
                total[ti] = r.total_gpus
                faulty[si, ti] = r.faulty_gpus
                placed[si, ti] = r.placed_gpus
        return BatchedWasteResult(tps, total, faulty, placed)

    def _clip_masks(self, fault_masks: np.ndarray) -> np.ndarray:
        masks = np.asarray(fault_masks, dtype=bool)
        if masks.ndim != 2:
            raise ValueError(f"fault_masks must be 2-D, got {masks.shape}")
        if masks.shape[1] >= self.num_nodes:
            return masks[:, :self.num_nodes]
        pad = np.zeros((masks.shape[0], self.num_nodes - masks.shape[1]), bool)
        return np.concatenate([masks, pad], axis=1)

    def _faulty_gpus(self, faults: Set[int]) -> int:
        return len(faults) * self.gpus_per_node


class BigSwitch(HBDModel):
    """Theoretical upper bound: any healthy GPU can join any group."""

    name = "big-switch"

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        healthy = self.total_gpus - self._faulty_gpus(faults)
        placed = (healthy // tp_size) * tp_size
        return WasteResult(self.total_gpus, self._faulty_gpus(faults), placed)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        faulty = masks.sum(axis=1, dtype=np.int64)[:, None] * self.gpus_per_node
        healthy = self.total_gpus - faulty                       # (S, 1)
        placed = (healthy // tps[None, :]) * tps[None, :]        # (S, T)
        total = np.full(len(tps), self.total_gpus, dtype=np.int64)
        return BatchedWasteResult(tps, total,
                                  np.broadcast_to(faulty, placed.shape).copy(),
                                  placed)


class InfiniteHBDModel(HBDModel):
    """K-hop ring across the whole datacenter (paper's design)."""

    name = "infinitehbd"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4, k: int = 3,
                 closed_ring: bool = True):
        super().__init__(num_nodes, gpus_per_node)
        self.k = k
        self.closed_ring = closed_ring
        self.name = f"infinitehbd-k{k}"

    def _static_config(self) -> tuple:
        return (self.k, self.closed_ring)

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        m = max(1, tp_size // self.gpus_per_node)
        order = list(range(self.num_nodes))
        comps = healthy_components(order, faults, self.k)
        # on a closed ring the first and last components merge when the
        # wrap-around fault gap is shorter than K
        if self.closed_ring and len(comps) > 1:
            head, tail = comps[0], comps[-1]
            wrap_gap = (head[0] + self.num_nodes) - tail[-1] - 1
            if wrap_gap < self.k:
                comps[0] = tail + head
                comps.pop()
        placed_nodes = sum((len(c) // m) * m for c in comps)
        return WasteResult(self.total_gpus, self._faulty_gpus(faults),
                           placed_nodes * self.gpus_per_node)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        """Sparse K-hop component analysis over all snapshots at once.

        Faults are sparse in every regime the paper studies (2.33%
        stationary mean), so the kernel works on the extracted fault
        stream instead of dense per-node scans: a component break is a
        maximal run of >= K consecutive faults, and each inter-break
        segment's healthy-node count is pure column/stream-index
        arithmetic -- O(faults) work past the one ``nonzero`` pass,
        ~20x the dense formulation at trace fault ratios.
        """
        snaps, n = masks.shape
        k = self.k
        g = self.gpus_per_node
        rows, cols = np.nonzero(masks)      # row-major; cols ascend per row
        nf = np.bincount(rows, minlength=snaps).astype(np.int64)

        # maximal consecutive-fault runs of the stream
        if rows.size:
            new_run = np.ones(rows.size, dtype=bool)
            new_run[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1] + 1)
            r0 = np.flatnonzero(new_run)            # stream idx of run start
            rlen = np.diff(np.append(r0, rows.size))
            rrow, rc0 = rows[r0], cols[r0]
            rc1 = rc0 + rlen - 1
        else:
            r0 = rlen = rrow = rc0 = rc1 = np.zeros(0, dtype=np.int64)

        brk = rlen >= k                             # runs that split the line
        brow, bs, be = rrow[brk], rc0[brk], rc1[brk]
        bi0 = r0[brk]
        bi1 = bi0 + rlen[brk]
        rr = np.arange(snaps)
        fr0 = np.searchsorted(rows, rr, side="left")    # per-row fault span
        fr1 = np.searchsorted(rows, rr, side="right")
        row_first = np.searchsorted(brow, rr, side="left")
        row_last = np.searchsorted(brow, rr, side="right")
        nbrk = row_last - row_first

        # healthy-node count of every segment between/around a row's breaks:
        # (column span) - (faults inside it, via stream-index differences)
        br_rows = np.flatnonzero(nbrk > 0)
        fidx = row_first[br_rows]                   # first/last break per row
        lidx = row_last[br_rows] - 1
        h_lead = bs[fidx] - (bi0[fidx] - fr0[br_rows])
        h_trail = (n - 1 - be[lidx]) - (fr1[br_rows] - bi1[lidx])
        pair = (brow[1:] == brow[:-1]) if brow.size else np.zeros(0, bool)
        h_mid = ((bs[1:] - be[:-1] - 1) - (bi0[1:] - bi1[:-1]))[pair]
        seg_rows = np.concatenate([br_rows, br_rows, brow[:-1][pair]])
        seg_h = np.concatenate([h_lead, h_trail, h_mid])

        # closed-ring wrap: the head and tail components merge when the
        # fault runs touching the two row edges sum to < K.  (Edge runs of
        # >= K are breaks and fail the test; sub-K edge runs leave the
        # lead/trail segments non-empty, so those ARE the head/tail
        # components whenever the row has a break.)
        mergeable = np.zeros(0, dtype=bool)
        if self.closed_ring and br_rows.size:
            first_run = np.searchsorted(rrow, br_rows, side="left")
            last_run = np.searchsorted(rrow, br_rows, side="right") - 1
            lead_len = np.where(rc0[first_run] == 0, rlen[first_run], 0)
            trail_len = np.where(rc1[last_run] == n - 1, rlen[last_run], 0)
            mergeable = (lead_len + trail_len) < k

        placed = np.zeros((snaps, len(tps)), dtype=np.int64)
        base_h = np.where(nbrk == 0, n - nf, 0)     # break-free rows: 1 comp
        for ti, tp in enumerate(tps):
            m = max(1, int(tp) // g)
            nodes = (base_h // m) * m
            if seg_rows.size:
                nodes = nodes + np.bincount(
                    seg_rows, weights=(seg_h // m) * m,
                    minlength=snaps).astype(np.int64)
            if mergeable.size and mergeable.any():
                delta = (((h_lead + h_trail) // m) * m
                         - (h_lead // m) * m - (h_trail // m) * m)
                add = np.zeros(snaps, dtype=np.int64)
                add[br_rows] = np.where(mergeable, delta, 0)
                nodes = nodes + add
            placed[:, ti] = nodes * g
        faulty = (nf * g)[:, None]
        total = np.full(len(tps), self.total_gpus, dtype=np.int64)
        return BatchedWasteResult(tps, total,
                                  np.broadcast_to(faulty, placed.shape).copy(),
                                  placed)


class NVLModel(HBDModel):
    """Switch-centric islands (NVL-36/72/576).

    ``spare_fraction``: NVL-36/72 deployments reserve 1/9 of GPUs as hot
    spares (paper §6.2: "1/9 of GPUs are reserved for redundant backups");
    reserved-but-unused spares count as waste.  Inside an island any healthy
    compute GPU can join any group (full CCL), so waste beyond spares is the
    (avail mod tp) fragmentation term.
    """

    name = "nvl"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4,
                 hbd_gpus: int = 72, spare_fraction: float = 1.0 / 9.0):
        super().__init__(num_nodes, gpus_per_node)
        self.hbd_gpus = hbd_gpus
        self.spare_fraction = spare_fraction
        self.name = f"nvl-{hbd_gpus}"

    def _static_config(self) -> tuple:
        return (self.hbd_gpus, self.spare_fraction)

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        nodes_per_hbd = self.hbd_gpus // self.gpus_per_node
        n_hbd = self.num_nodes // nodes_per_hbd
        spares = int(round(self.hbd_gpus * self.spare_fraction))
        compute = self.hbd_gpus - spares
        placed = 0
        for h in range(n_hbd):
            lo = h * nodes_per_hbd
            f_gpus = sum(self.gpus_per_node for u in range(lo, lo + nodes_per_hbd)
                         if u in faults)
            # faults consume spares first, then compute capacity
            avail = compute - max(0, f_gpus - spares)
            avail = max(avail, 0)
            placed += (avail // tp_size) * tp_size
        return WasteResult(n_hbd * self.hbd_gpus,
                           self._faulty_gpus({u for u in faults
                                              if u < n_hbd * nodes_per_hbd}),
                           placed)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        npn = self.hbd_gpus // self.gpus_per_node
        n_hbd = self.num_nodes // npn
        spares = int(round(self.hbd_gpus * self.spare_fraction))
        compute = self.hbd_gpus - spares
        per_isle = masks[:, :n_hbd * npn].reshape(masks.shape[0], n_hbd, npn)
        f_gpus = per_isle.sum(axis=2, dtype=np.int64) * self.gpus_per_node
        avail = np.maximum(compute - np.maximum(f_gpus - spares, 0), 0)
        placed = ((avail[:, :, None] // tps) * tps).sum(axis=1)     # (S, T)
        faulty = f_gpus.sum(axis=1)[:, None]
        total = np.full(len(tps), n_hbd * self.hbd_gpus, dtype=np.int64)
        return BatchedWasteResult(tps, total,
                                  np.broadcast_to(faulty, placed.shape).copy(),
                                  placed)


class TPUv4Model(HBDModel):
    """Cube-granular hybrid: 64-TPU cubes behind central OCS switches.

    Resource management is cube-granular (§2.2).  For TP <= 64 a cube is
    carved into TP-sized sub-blocks and a fault poisons its whole sub-block
    (the OCS cannot re-splice inside a cube); for TP > 64 groups are unions
    of whole cubes and any fault withholds its entire cube.  This calibration
    reproduces the paper's 7.56% waste at TP-32 on the production trace while
    still "significantly degrading with larger TP sizes".
    """

    name = "tpuv4"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4, cube_gpus: int = 64):
        super().__init__(num_nodes, gpus_per_node)
        self.cube_gpus = cube_gpus

    def _static_config(self) -> tuple:
        return (self.cube_gpus,)

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        nodes_per_cube = self.cube_gpus // self.gpus_per_node
        n_cubes = self.num_nodes // nodes_per_cube
        total = n_cubes * self.cube_gpus
        faulty = self._faulty_gpus({u for u in faults if u < n_cubes * nodes_per_cube})
        if tp_size <= self.cube_gpus:
            # sub-block granularity inside each cube
            block_nodes = max(1, tp_size // self.gpus_per_node)
            placed = 0
            for c in range(n_cubes):
                lo = c * nodes_per_cube
                for b in range(lo, lo + nodes_per_cube, block_nodes):
                    if not any(u in faults for u in range(b, b + block_nodes)):
                        placed += tp_size
            return WasteResult(total, faulty, placed)
        # TP spans multiple cubes: only fully healthy cubes are schedulable
        healthy_cubes = 0
        for c in range(n_cubes):
            lo = c * nodes_per_cube
            if not any(u in faults for u in range(lo, lo + nodes_per_cube)):
                healthy_cubes += 1
        usable = healthy_cubes * self.cube_gpus
        placed = (usable // tp_size) * tp_size
        return WasteResult(total, faulty, placed)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        g = self.gpus_per_node
        npc = self.cube_gpus // g
        n_cubes = self.num_nodes // npc
        snaps = masks.shape[0]
        per_cube = masks[:, :n_cubes * npc].reshape(snaps, n_cubes, npc)
        faulty = per_cube.sum(axis=(1, 2), dtype=np.int64)[:, None] * g
        healthy_cubes = (~per_cube.any(axis=2)).sum(axis=1, dtype=np.int64)
        placed = np.zeros((snaps, len(tps)), dtype=np.int64)
        for ti, tp in enumerate(tps):
            tp = int(tp)
            if tp <= self.cube_gpus:
                # sub-block grid; blocks at a cube's tail may overrun into the
                # neighbor (same quirk as the scalar loop) -- clip at N
                bn = max(1, tp // g)
                starts = np.arange(0, npc, bn)
                ids = (np.arange(n_cubes)[:, None, None] * npc
                       + starts[None, :, None]
                       + np.arange(bn)[None, None, :])        # (cubes, blocks, bn)
                in_range = ids < self.num_nodes
                f = masks[:, np.minimum(ids, self.num_nodes - 1)] & in_range
                placed[:, ti] = (~f.any(axis=3)).sum(axis=(1, 2)) * tp
            else:
                usable = healthy_cubes * self.cube_gpus
                placed[:, ti] = (usable // tp) * tp
        total = np.full(len(tps), n_cubes * self.cube_gpus, dtype=np.int64)
        return BatchedWasteResult(tps, total,
                                  np.broadcast_to(faulty, placed.shape).copy(),
                                  placed)


class SiPRingModel(HBDModel):
    """Static fixed-size rings (SiP-Ring): ring size == TP size; any fault
    breaks the ring into a line which cannot run ring TP of that size."""

    name = "sip-ring"

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        nodes_per_ring = max(1, tp_size // self.gpus_per_node)
        n_rings = self.num_nodes // nodes_per_ring
        placed = 0
        for rng_i in range(n_rings):
            lo = rng_i * nodes_per_ring
            if not any(u in faults for u in range(lo, lo + nodes_per_ring)):
                placed += tp_size
        total = n_rings * nodes_per_ring * self.gpus_per_node
        faulty = self._faulty_gpus({u for u in faults
                                    if u < n_rings * nodes_per_ring})
        return WasteResult(total, faulty, placed)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        snaps = masks.shape[0]
        total = np.zeros(len(tps), dtype=np.int64)
        faulty = np.zeros((snaps, len(tps)), dtype=np.int64)
        placed = np.zeros((snaps, len(tps)), dtype=np.int64)
        for ti, tp in enumerate(tps):
            tp = int(tp)
            npr = max(1, tp // self.gpus_per_node)
            n_rings = self.num_nodes // npr
            rings = masks[:, :n_rings * npr].reshape(snaps, n_rings, npr)
            placed[:, ti] = (~rings.any(axis=2)).sum(axis=1, dtype=np.int64) * tp
            faulty[:, ti] = rings.sum(axis=(1, 2), dtype=np.int64) * self.gpus_per_node
            total[ti] = n_rings * npr * self.gpus_per_node
        return BatchedWasteResult(tps, total, faulty, placed)


def default_suite(num_nodes: int, gpus_per_node: int = 4) -> List[HBDModel]:
    """The §6.1 evaluation suite."""
    return [
        BigSwitch(num_nodes, gpus_per_node),
        InfiniteHBDModel(num_nodes, gpus_per_node, k=2),
        InfiniteHBDModel(num_nodes, gpus_per_node, k=3),
        NVLModel(num_nodes, gpus_per_node, hbd_gpus=36),
        NVLModel(num_nodes, gpus_per_node, hbd_gpus=72),
        NVLModel(num_nodes, gpus_per_node, hbd_gpus=576, spare_fraction=0.0),
        TPUv4Model(num_nodes, gpus_per_node),
        SiPRingModel(num_nodes, gpus_per_node),
    ]
