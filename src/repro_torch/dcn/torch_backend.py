"""torch backend for the batched fat-tree placement kernel.

The counterpart of ``repro.dcn.jax_backend``: the Algorithm-4/5 pipeline
of :mod:`repro_torch.dcn.kernel` -- masked tier carves, the count-vector
binary search with a static trip count, scatter/lexsort materialization --
as torch functions batched over the snapshot rows, where the JAX package
writes one snapshot and maps it with ``jax.vmap``.

Every prefix sum on this path goes through the hand-written CUDA scan
(``repro_torch.kernels.prefix_scan``; its plain version on CPU tensors):
the carve's healthy and fault prefixes and the materialization's placed
prefixes.  One (block, TP) call launches it :func:`scans_per_call` times,
``4 * (iters + 1) + 2`` on the configurations the sweeps run.

The device kernel emits the placement *member* grid; DP-ring pair
counting happens on the host through ``kernel.batched_pair_counts``, as in
the JAX package, so traffic counts can only disagree if the placements
do.  All device arithmetic is int32 and widened to int64 on the host; the
placements are bit-for-bit those of :func:`repro_torch.dcn.kernel.
batched_fat_tree` (``tests/test_torch_dcn.py`` on the CPU, ``chip_smoke.py``
on the card).  The device defaults to ``cuda``, which raises without a
card.  As in the sweep (:func:`repro_torch.sim.torch_backend.devices`),
``device`` may name several devices, or several slices of one: each block's
rows are padded with fault-free masks to a multiple of :func:`num_devices`
and split into equal slices, one a device, as ``repro``'s ``shard_map``
splits them over the JAX devices.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import obs
from ..kernels.prefix_scan import prefix_scan
from ..sim.torch_backend import Slices, _stage, devices, num_devices, pad_rows
from .kernel import BatchedPlacement, FatTreeConfig

_I32 = torch.int32


def search_iters(cfg: FatTreeConfig) -> int:
    """Probes of the binary search: the JAX package's static trip count."""
    return cfg.max_constraints.bit_length() + 1


def scans_per_call(cfg: FatTreeConfig, tp_size: int) -> int:
    """``prefix_scan`` launches of one (block, TP) call on a block of at
    least one row: 2 scans a carve (1 on a line shorter than ``k``), a
    tier and a residual carve per probe and once more to materialize, then
    one placed prefix each for the tier slots and the residual groups."""
    m = cfg.group_nodes(tp_size)

    def carve(length: int) -> int:
        return 2 if length >= cfg.k else 1

    scheme = carve(cfg.tors_per_domain) + carve(cfg.num_nodes)
    slots = cfg.n_domains * cfg.nodes_per_tor * (cfg.tors_per_domain // m)
    return (scheme * (search_iters(cfg) + 1) + int(slots > 0)
            + int(cfg.num_nodes // m > 0))


def _carve(f: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """:func:`repro_torch.dcn.kernel.line_carve` along the last axis."""
    length = f.shape[-1]
    healthy = ~f
    hc = prefix_scan(healthy)
    before = hc - healthy.to(_I32)             # exclusive healthy prefix
    total = hc[..., -1:]
    runk = torch.zeros_like(f)
    if length >= k:
        fc = prefix_scan(f)
        # a run of k faults ends at i: faults in (i-k, i] == k
        runk[..., k - 1] = fc[..., k - 1] == k
        runk[..., k:] = (fc[..., k:] - fc[..., :length - k]) == k
    comp_start = torch.cummax(torch.where(runk, before, 0), dim=-1).values
    comp_end = torch.cummin(torch.where(runk, before, total).flip(-1),
                            dim=-1).values.flip(-1)
    rank = before - comp_start                 # >= 0: % and // stay exact
    size = comp_end - comp_start
    return healthy & (rank - rank % m + m <= size)


def _stable_lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise ``jnp.lexsort``: ``keys`` are ``(rows, L)``, the last one
    primary.  Stable sorts chained from ``keys[0]`` to ``keys[-1]``."""
    perm = None
    for key in keys:
        cur = key if perm is None else key.gather(1, perm)
        idx = torch.sort(cur, dim=1, stable=True).indices
        perm = idx if perm is None else perm.gather(1, idx)
    return perm


class _Placer:
    """Algorithm 5 for one (geometry, TP, job) on one device, applied to
    blocks of snapshot masks."""

    def __init__(self, cfg: FatTreeConfig, tp_size: int, job_gpus: int,
                 device: torch.device):
        self.cfg, self.device = cfg, device
        self.m = cfg.group_nodes(tp_size)
        self.need = cfg.need_groups(tp_size, job_gpus)
        n, p, d, tpd = (cfg.num_nodes, cfg.nodes_per_tor, cfg.n_domains,
                        cfg.tors_per_domain)
        self.iters = search_iters(cfg)
        self.g_max = tpd // self.m
        self.slots = d * p * self.g_max
        self.rs = n // self.m

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self.order = dev(cfg.order().astype(np.int32))   # node ids
        self.order_idx = self.order.long()                # their gather
        self.d_idx = dev(np.arange(d, dtype=np.int32))
        self.i_idx = dev(np.arange(p, dtype=np.int32))
        node_of = (np.arange(d, dtype=np.int32)[:, None, None] * cfg.agg_domain
                   + np.arange(tpd, dtype=np.int32)[None, None, :] * p
                   + np.arange(p, dtype=np.int32)[None, :, None])
        self.node_of = dev(node_of)                      # (D, P, Tpd)
        g = self.g_max
        self.dom_k = dev(np.repeat(np.arange(d, dtype=np.int32), p * g))
        self.pos_k = dev(np.tile(np.arange(g, dtype=np.int32), d * p))
        self.idx_k = dev(np.tile(np.repeat(np.arange(p, dtype=np.int32), g),
                                 d))

    def _views(self, masks: torch.Tensor):
        """Raw and ToR-aligned fault masks on the (D, P, Tpd) chunk grid."""
        cfg = self.cfg
        rows = masks.shape[0]
        grid = masks.reshape(rows, cfg.n_domains, cfg.tors_per_domain,
                             cfg.nodes_per_tor)
        aligned = grid.any(dim=3, keepdim=True).expand_as(grid)
        return (grid.transpose(2, 3).contiguous(),
                aligned.transpose(2, 3).contiguous())

    def _scheme(self, masks, raw, aligned, c):
        """Tier and residual placed masks at per-row constraint level ``c``."""
        cfg, m = self.cfg, self.m
        rows = masks.shape[0]
        n_sub = torch.clamp(c, max=cfg.nodes_per_tor)
        n_align = torch.clamp(c - cfg.nodes_per_tor, 0, cfg.n_domains)
        use_aligned = (self.d_idx[None, :] < n_align[:, None])[:, :, None, None]
        eff = torch.where(use_aligned, aligned, raw)
        placed_tier = (_carve(eff, cfg.k, m)
                       & (self.i_idx[None, :] < n_sub[:, None])[:, None, :, None])
        used = placed_tier.transpose(2, 3).reshape(rows, cfg.num_nodes)
        placed_res = _carve((masks | used)[:, self.order_idx], cfg.k, m)
        return placed_tier, placed_res

    def place(self, masks: torch.Tensor):
        """``(rows, num_nodes)`` bool -> members ``(rows, need, m)``,
        feasible ``(rows,)`` and n_constraints ``(rows,)``, int32 on the
        device (``-1`` where infeasible)."""
        cfg, m, need = self.cfg, self.m, self.need
        rows = masks.shape[0]
        raw, aligned = self._views(masks)

        # Algorithm 5's binary search: the same `iters` probes as the JAX
        # package's fori_loop, each row with its own lo, hi and mid
        lo = torch.zeros(rows, dtype=_I32, device=self.device)
        hi = torch.full((rows,), cfg.max_constraints, dtype=_I32,
                        device=self.device)
        best = torch.full((rows,), -1, dtype=_I32, device=self.device)
        for _ in range(self.iters):
            active = lo <= hi
            # lo + hi >= 0 on active rows; an inactive row's probe is
            # discarded, so its sum is clamped to keep // non-negative
            mid = torch.clamp(lo + hi, min=0) // 2
            placed_tier, placed_res = self._scheme(masks, raw, aligned, mid)
            counts = (placed_tier.sum(dim=(1, 2, 3), dtype=_I32) // m
                      + placed_res.sum(dim=1, dtype=_I32) // m)
            feas = active & (counts >= need)
            lo = torch.where(feas, mid + 1, lo)
            hi = torch.where(active & ~feas, mid - 1, hi)
            best = torch.where(feas, mid, best)
        feasible = best >= 0
        placed_tier, placed_res = self._scheme(masks, raw, aligned,
                                               torch.clamp(best, min=0))

        if self.slots:
            tier_sorted, tier_count = self._tier_groups(placed_tier)
        else:
            tier_sorted = torch.zeros((rows, 0, m), dtype=_I32,
                                      device=self.device)
            tier_count = torch.zeros(rows, dtype=_I32, device=self.device)
        res_nodes = self._residual_groups(placed_res)
        all_groups = torch.cat([tier_sorted, res_nodes], dim=1)

        j = torch.arange(need, dtype=_I32, device=self.device)[None, :]
        tc = tier_count[:, None]
        gather = torch.where(j < tc, j, tier_sorted.shape[1] + j - tc)
        gather = torch.clamp(gather, 0, all_groups.shape[1] - 1).long()
        members = all_groups.gather(1, gather[:, :, None].expand(-1, -1, m))
        members = torch.where(feasible[:, None, None], members, -1)
        return members, feasible, torch.where(feasible, best, -1)

    def _scatter(self, placed: torch.Tensor, group_rows: int,
                 values: torch.Tensor) -> torch.Tensor:
        """Groups ``(rows, group_rows, m)`` of a placed mask whose last axis
        is carved in order: the node at ``values`` goes to group
        ``pc // m``, rank ``pc % m`` of its line, ``pc`` the exclusive
        placed prefix.  Lines are the leading axes past the row axis, each
        owning ``group_rows // lines`` groups; unplaced positions (the JAX
        package's out-of-bounds ids, dropped) are masked out before the
        write, whose targets are then unique."""
        m = self.m
        rows = placed.shape[0]
        pc = prefix_scan(placed) - placed.to(_I32)
        lines = placed[0].numel() // placed.shape[-1]
        per_line = group_rows // lines
        line_id = torch.arange(rows * lines, dtype=torch.int64,
                               device=self.device).view(placed.shape[:-1])
        target = ((line_id[..., None] * per_line + (pc // m).long()) * m
                  + (pc % m).long())
        out = torch.full((rows * group_rows * m,), -1, dtype=_I32,
                         device=self.device)
        out[target[placed]] = values.expand_as(placed)[placed]
        return out.view(rows, group_rows, m)

    def _tier_groups(self, placed_tier: torch.Tensor):
        """Tier groups in Algorithm 4's DP-ring order, and their count."""
        cfg = self.cfg
        rows = placed_tier.shape[0]
        flat = self._scatter(placed_tier, self.slots, self.node_of)
        valid = flat[:, :, 0] >= 0
        sig = torch.where(flat >= 0, flat.clamp(min=0) // cfg.nodes_per_tor,
                          cfg.num_nodes)
        dom_k = torch.where(valid, self.dom_k, cfg.n_domains)
        keys = ([self.idx_k.expand(rows, -1), self.pos_k.expand(rows, -1)]
                + [sig[:, :, r] for r in range(self.m - 1, -1, -1)] + [dom_k])
        perm = _stable_lexsort(keys)
        tier_sorted = flat.gather(1, perm[:, :, None].expand(-1, -1, self.m))
        return tier_sorted, valid.sum(dim=1, dtype=_I32)

    def _residual_groups(self, placed_res: torch.Tensor) -> torch.Tensor:
        """Residual groups in carve order along the deployment order."""
        rows = placed_res.shape[0]
        if not self.rs:
            return torch.full((rows, 1, self.m), -1, dtype=_I32,
                              device=self.device)
        return self._scatter(placed_res, self.rs, self.order)


def fat_tree_placements(masks: np.ndarray, cfg: FatTreeConfig,
                        tp_sizes: Sequence[int], job_gpus: Sequence[int], *,
                        chunk_snapshots: int = 1024, device="cuda"
                        ) -> List[BatchedPlacement]:
    """Device-evaluated Algorithm-5 placements, one grid per TP size.

    Returns host :class:`BatchedPlacement` objects bit-for-bit equal to
    :func:`repro_torch.dcn.kernel.batched_fat_tree` on the same masks.
    Blocks of ``chunk_snapshots`` rows (rounded up to a multiple of the
    slice count) go to ``device`` one at a time, split over its slices.
    """
    slices = Slices(devices(device))
    ndev = len(slices.devices)
    if not cfg.regular():
        raise ValueError("torch fat-tree kernel requires regular geometry")
    masks = np.asarray(masks, dtype=bool)
    snaps = masks.shape[0]
    tps = [int(t) for t in tp_sizes]
    jobs = [int(j) for j in job_gpus]
    outs = []
    for tp, job in zip(tps, jobs):
        m = cfg.group_nodes(tp)
        need = cfg.need_groups(tp, job)
        outs.append(BatchedPlacement(
            np.full((snaps, need, m), -1, dtype=np.int32),
            np.zeros(snaps, bool), np.full(snaps, -1, np.int64), need, m))
    if snaps == 0:
        return outs
    if masks.shape[1] != cfg.num_nodes:
        # the NumPy kernel rejects the mismatch in its chunk-grid reshape;
        # the backends must not diverge on bad input
        raise ValueError(
            f"fault masks have {masks.shape[1]} columns, expected "
            f"num_nodes={cfg.num_nodes}")

    placers = {}                 # one set a distinct device, shared by its slices
    for dev in slices.devices:
        if dev not in placers:
            placers[dev] = [_Placer(cfg, tp, job, dev) for tp, job in zip(tps, jobs)]

    def place(part, dev, held):
        block = _stage(part, dev, held)
        res = []
        for placer in placers[dev]:
            res.extend(placer.place(block))
        return res

    chunk = max(1, chunk_snapshots)
    chunk = -(-chunk // ndev) * ndev
    for lo in range(0, snaps, chunk):
        hi = min(lo + chunk, snaps)
        with obs.span("dcn.torch.place_block", rows=hi - lo, devices=ndev):
            parts = slices.run(place, pad_rows(masks[lo:hi], ndev, counter=False))
            for ti, out in enumerate(outs):
                members, feasible, n_c = (np.concatenate([p[3 * ti + j] for p in parts])
                                          [:hi - lo] for j in range(3))
                out.members[lo:hi] = members
                out.feasible[lo:hi] = feasible
                out.n_constraints[lo:hi] = n_c.astype(np.int64)
    return outs


__all__ = ["fat_tree_placements", "num_devices", "scans_per_call", "search_iters"]
