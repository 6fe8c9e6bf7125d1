"""Plain PyTorch version of the prefix scan: the literal inclusive int32
cumulative sum along the last axis, as ``repro.kernels.prefix_scan.ref``.
CPU tensors take it in :mod:`.prefix_scan`; on the card it is what the
kernel is held against."""

from __future__ import annotations

import torch


def prefix_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last axis of a mask or count
    tensor (any leading axes; int32 wraps as the kernel does)."""
    return torch.cumsum(x.to(torch.int32), -1, dtype=torch.int32)
