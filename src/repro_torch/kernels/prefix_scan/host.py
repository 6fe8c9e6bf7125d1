"""Host-side fused mask cumsum: recursively blocked float32 GEMMs.

NumPy's ``cumsum`` walks the scan axis as a scalar loop; BLAS does not.
An inclusive prefix sum of a 0/1 mask is one matmul against a triangular
ones matrix -- exact in float32 because every partial count is an integer
``<= length`` -- and for long axes the matmul is *blocked*: per-block
prefix sums from a ``(block, block)`` GEMM, plus a carry that is itself
the (exclusive) prefix sum of the per-block totals, computed by recursing
on an axis ``block``-times shorter.  Total work is ``O(n * block)``
instead of the dense GEMM's ``O(n^2)``, every step is vectorized, and the
single-block case is bit-for-bit the historical GEMM-as-cumsum trick the
DCN kernel shipped (pinned by ``tests/test_prefix_scan.py``).

A copy of ``repro.kernels.prefix_scan.host``, held to it by
``tests/test_torch_dcn.py``.  NumPy only: it is the host scan of the
port's NumPy DCN kernel (``repro_torch.dcn.kernel``); the torch backend
takes its scans through the CUDA kernel in :mod:`.prefix_scan` instead.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: Counts above ``2**24`` are not exactly representable in float32; the
#: GEMM switches to float64 (exact through ``2**53``) past this length.
_F32_EXACT = 1 << 24

_TRI_CACHE: Dict[Tuple[int, str], np.ndarray] = {}


def _tri(block: int, dtype: np.dtype) -> np.ndarray:
    """Upper-triangular ones: ``tri[i, j] = 1 iff i <= j``, so
    ``mask @ tri`` is the inclusive prefix sum along the last axis."""
    key = (block, np.dtype(dtype).str)
    t = _TRI_CACHE.get(key)
    if t is None:
        t = np.tril(np.ones((block, block), dtype=dtype)).T
        _TRI_CACHE[key] = t
    return t


def mask_cumsum(mask: np.ndarray, block: int = 128) -> np.ndarray:
    """Inclusive int32 prefix sum of a boolean mask along its last axis.

    Broadcasts over arbitrary leading axes.  Bit-for-bit equal to
    ``np.cumsum(mask, axis=-1, dtype=np.int32)`` for boolean input (the
    float GEMMs are exact on integer counts), at GEMM throughput on every
    axis length.
    """
    m = np.asarray(mask)
    if m.dtype != np.bool_:
        raise TypeError(f"mask_cumsum expects a boolean mask, got {m.dtype}")
    block = max(block, 2)        # block=1 cannot reduce the carry recursion
    length = m.shape[-1]
    ftype = np.float32 if length < _F32_EXACT else np.float64
    if length == 0:
        return np.zeros(m.shape, dtype=np.int32)
    if length <= block:
        # single block: exactly the historical GEMM-as-cumsum trick
        return (m.astype(ftype) @ _tri(length, ftype)).astype(np.int32)
    n_blocks = -(-length // block)
    pad = n_blocks * block - length
    if pad:
        m = np.concatenate(
            [m, np.zeros(m.shape[:-1] + (pad,), dtype=bool)], axis=-1)
    blocks = m.reshape(m.shape[:-1] + (n_blocks, block))
    within = blocks.astype(ftype) @ _tri(block, ftype)
    # carry = exclusive prefix sum of the per-block totals: recurse on the
    # block axis (block-times shorter), staying on the GEMM path throughout
    totals = within[..., -1].astype(np.int32)
    carry = _int_cumsum(totals, block) - totals
    out = within.astype(np.int32)
    out += carry[..., None]
    return out.reshape(m.shape)[..., :length]


def _int_cumsum(counts: np.ndarray, block: int) -> np.ndarray:
    """Inclusive prefix sum of small non-negative int32 counts along the
    last axis, via the same blocked-GEMM recursion as :func:`mask_cumsum`
    (exact: every partial sum stays far below the float mantissa)."""
    block = max(block, 2)
    length = counts.shape[-1]
    ftype = np.float32 if length * int(block) < _F32_EXACT else np.float64
    if length <= block:
        return (counts.astype(ftype) @ _tri(length, ftype)).astype(np.int32)
    n_blocks = -(-length // block)
    pad = n_blocks * block - length
    if pad:
        counts = np.concatenate(
            [counts, np.zeros(counts.shape[:-1] + (pad,), np.int32)],
            axis=-1)
    blocks = counts.reshape(counts.shape[:-1] + (n_blocks, block))
    within = blocks.astype(ftype) @ _tri(block, ftype)
    totals = within[..., -1].astype(np.int32)
    carry = _int_cumsum(totals, block) - totals
    out = within.astype(np.int32)
    out += carry[..., None]
    return out.reshape(counts.shape)[..., :length]


__all__ = ["mask_cumsum"]
