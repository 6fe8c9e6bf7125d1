"""Wrapper of the CUDA prefix-scan kernel (``csrc/prefix_scan.cu``).

``prefix_scan(x)`` computes what
``repro.kernels.prefix_scan.prefix_scan_pallas`` computes -- the inclusive
int32 prefix sum along the last axis -- for bool, uint8 or int32 input with
any leading axes.  On CPU tensors it runs the plain version
:func:`prefix_scan_ref`; on CUDA tensors it launches the kernel on the route
:func:`scan_route` picks for the shape; any other device raises.
``mask_cumsum(mask)`` is the same entry point for bool masks only (the
signature of ``repro.kernels.prefix_scan.host``).  ``prefix_scan.launches``
counts kernel launches; an empty input returns zeros without one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .ref import prefix_scan_ref

#: input element kinds of the C entry point
_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int32: 1}
#: elements each thread loads and stores at once (uchar4 / int4 vectors)
ITEMS = 4
_VEC_BYTES = {0: 4, 1: 16}          # kind -> bytes of one thread's load
#: the kernel's block, and how many of them a persistent grid keeps on an SM
THREADS = 256
BLOCKS_PER_SM = 8
#: A row longer than BLOCK_LENGTH takes the block route when the warp route
#: (a warp a row) would give the card fewer than WARPS_PER_SM warps an SM;
#: a block is then given at least BLOCK_TILES tiles of 1024 elements (its
#: two steps in flight) while the grid keeps 2 blocks an SM.  Measured on
#: an H100 (tools/prefix_scan_bench.py routes): below 1025 entries the warp
#: route wins at every row count, above it the block route below 4224 rows.
BLOCK_LENGTH = 1024
WARPS_PER_SM = 32
BLOCK_TILES = 8
_ROUTES = {"warp": 0, "block": 1}

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


class ScanRoute(NamedTuple):
    """How the kernel scans a (rows, length) input: ``route`` "warp" (a
    team of ``lanes`` lanes a row, 32 // lanes rows a warp) or "block" (256
    threads a row, ``lanes`` 0); ``vec`` vector loads and stores, else
    element access under bounds checks; ``grid`` blocks of 256 threads."""

    route: str
    lanes: int
    vec: bool
    grid: int


def scan_route(rows: int, length: int, kind: int, aligned: bool,
               sms: int = 132) -> ScanRoute:
    """The route of a launch over ``rows`` rows of ``length`` elements of
    ``kind`` (0: 1-byte, 1: int32) whose base pointer is ``aligned`` to the
    kind's vector (4 or 16 bytes), on a card of ``sms`` SMs.  Both
    ``rows`` and ``length`` are at least 1."""
    vec = bool(aligned) and length % ITEMS == 0
    resident = sms * BLOCKS_PER_SM
    if length > BLOCK_LENGTH and rows < sms * WARPS_PER_SM:
        tiles = rows * -(-length // (THREADS * ITEMS))
        return ScanRoute("block", 0, vec,
                         min(rows, resident, max(2 * sms, -(-tiles // BLOCK_TILES))))
    lanes = min(32, 1 << max(0, -(-length // ITEMS) - 1).bit_length())
    warps = -(-rows // (32 // lanes))          # warps the warp route fills
    return ScanRoute("warp", lanes, vec, min(-(-warps * 32 // THREADS), resident))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route_of(x: torch.Tensor) -> ScanRoute:
    """The route :func:`prefix_scan` takes for the CUDA tensor ``x`` (a
    non-contiguous one is copied first, to an aligned base)."""
    length = x.shape[-1]
    kind = _KINDS[x.dtype]
    aligned = not x.is_contiguous() or x.data_ptr() % _VEC_BYTES[kind] == 0
    return scan_route(x.numel() // length, length, kind, aligned, _sms(x.device.index or 0))


def _lib() -> ctypes.CDLL:
    lib = _build.load("prefix_scan")
    fn = lib.prefix_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_p, _p, _ll, _ll, _i, _i, _i, _i, _i, _p]
        fn.restype = _i
    return lib


def launch(x: torch.Tensor, out: torch.Tensor, route: ScanRoute) -> None:
    """Scan the contiguous CUDA tensor ``x`` into the int32 ``out`` of its
    shape on ``route`` (the kernel's entry point; counts no launch)."""
    length = x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().prefix_scan_launch(x.data_ptr(), out.data_ptr(), x.numel() // length, length,
                                    _KINDS[x.dtype], _ROUTES[route.route], route.lanes,
                                    int(route.vec), route.grid, stream)
    if err:
        raise RuntimeError(f"prefix_scan kernel launch failed: CUDA error {err}")


def prefix_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last axis of ``x`` (bool,
    uint8 or int32, at least 1-D); same shape, int32."""
    if x.device.type == "cpu":
        return prefix_scan_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_scan runs on cpu or cuda, not {x.device}")
    if x.dtype not in _KINDS:
        raise TypeError(f"prefix_scan takes bool, uint8 or int32, not {x.dtype}")
    if x.dim() == 0:
        raise ValueError("prefix_scan needs at least one dimension")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out.zero_()
    x = x.contiguous()
    launch(x, out, route_of(x))
    prefix_scan.launches += 1
    return out


prefix_scan.launches = 0


def mask_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """:func:`prefix_scan` of a boolean mask; raises ``TypeError`` for any
    other dtype, as ``repro.kernels.prefix_scan.host.mask_cumsum`` does."""
    if mask.dtype != torch.bool:
        raise TypeError(f"mask_cumsum expects a boolean mask, got {mask.dtype}")
    return prefix_scan(mask)
