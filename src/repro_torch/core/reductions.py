"""Shared grid and segment reductions for fault-sweep results.

A copy of ``repro.core.reductions``; in the port ``repro_torch.sim.tables``
uses the grid reductions, and the DCN slice will use the segment ones.

One implementation of the mean/percentile/threshold reductions that
``repro_torch.sim.tables`` (SweepResult grids) applies, pinned bit-for-bit
to the JAX package's tables by ``tests/test_torch_sweep.py``.  Keep the
float conversions exactly as they are: reordering them changes low bits
and breaks the pinning.

Also home to the sparse *segment* reductions of the batched DCN placement
hot path (:func:`run_segments`, :func:`segment_carve_counts`): the K-hop
component decomposition of a fault-mask batch expressed over the nonzero
stream alone, for the DCN kernel's carve counting and member compaction.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def waste_stats(series: np.ndarray) -> Tuple[float, float, float]:
    """(mean, P50, P99) of a waste-ratio series (Fig. 13/14 reductions)."""
    series = np.asarray(series)
    return (float(series.mean()), float(np.percentile(series, 50)),
            float(np.percentile(series, 99)))


def percentile_capacity(placed: np.ndarray, percentile: float = 5.0) -> float:
    """Placeable-GPU percentile over snapshots -- P5 is the job scale a long
    run could hold through ~95% of the trace (Fig. 15)."""
    return float(np.percentile(np.asarray(placed).astype(float), percentile))


def waiting_share(placed: np.ndarray, job_gpus: int) -> float:
    """Share of snapshots during which a ``job_gpus`` job cannot run because
    placeable capacity < requirement (Fig. 16/23)."""
    placed = np.asarray(placed)
    if not len(placed):
        return 0.0
    return float((placed < job_gpus).sum() / len(placed))


# ------------------------------------------------------ segment reductions

def run_segments(avail: np.ndarray, max_gap: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Run decomposition of a ``(rows, cols)`` bool matrix's nonzero stream.

    Returns ``(rows32, cols32, starts, seg_len)``: the row-major nonzero
    coordinates (int32), the stream offset where each maximal run starts,
    and each run's length.  A run breaks at a row change or at a column
    gap of ``>= max_gap`` missing positions -- exactly Algorithm 2's K-hop
    component rule, O(nonzeros) past one ``np.nonzero``.
    """
    avail = np.asarray(avail, dtype=bool)
    rows, cols = np.nonzero(avail)        # row-major; cols ascend per row
    if not rows.size:
        e32 = np.zeros(0, dtype=np.int32)
        return e32, e32, e32, np.zeros(0, dtype=np.int32)
    rows32 = rows.astype(np.int32)
    cols32 = cols.astype(np.int32)
    new_seg = np.ones(rows.size, dtype=bool)
    new_seg[1:] = ((rows32[1:] != rows32[:-1])
                   | (cols32[1:] - cols32[:-1] - 1 >= max_gap))
    starts = np.flatnonzero(new_seg).astype(np.int32)
    seg_len = np.diff(np.append(starts, np.int32(rows.size)))
    return rows32, cols32, starts, seg_len


def segment_carve_counts(avail: np.ndarray, max_gap: int, m: int,
                         rows: int) -> np.ndarray:
    """Per-row carved-node counts: each run places ``len // m * m`` nodes
    (complete groups of ``m`` inside the component), summed per row into an
    int64 vector of length ``rows``."""
    rows32, _, starts, seg_len = run_segments(avail, max_gap)
    if not rows32.size:
        return np.zeros(rows, dtype=np.int64)
    return np.bincount(rows32[starts], weights=(seg_len // m) * m,
                       minlength=rows).astype(np.int64)


__all__ = ["waste_stats", "percentile_capacity", "waiting_share",
           "run_segments", "segment_carve_counts"]
