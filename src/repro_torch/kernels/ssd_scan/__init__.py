"""Mamba-2 chunked SSD scan: forward and backward."""

from .ref import ssd_scan_bwd_ref, ssd_scan_ref
from .ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_fwd

__all__ = ["ssd_scan", "ssd_scan_bwd", "ssd_scan_fwd", "ssd_scan_bwd_ref", "ssd_scan_ref"]
