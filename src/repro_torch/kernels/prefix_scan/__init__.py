"""Inclusive int32 prefix scan along the last axis (mask cumsum)."""

from .prefix_scan import mask_cumsum, prefix_scan
from .ref import prefix_scan_ref

__all__ = ["mask_cumsum", "prefix_scan", "prefix_scan_ref"]
