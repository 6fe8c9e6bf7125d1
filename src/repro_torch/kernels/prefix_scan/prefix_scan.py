"""Wrapper of the CUDA prefix-scan kernel (``csrc/prefix_scan.cu``).

``prefix_scan(x)`` computes what
``repro.kernels.prefix_scan.prefix_scan_pallas`` computes -- the inclusive
int32 prefix sum along the last axis -- for bool, uint8 or int32 input with
any leading axes.  On CPU tensors it runs the plain version
:func:`prefix_scan_ref`; on CUDA tensors it launches the kernel; any other
device raises.  ``mask_cumsum(mask)`` is the same entry point for bool
masks only (the signature of ``repro.kernels.prefix_scan.host``).
``prefix_scan.launches`` counts kernel launches; an empty input returns
zeros without one.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import prefix_scan_ref

#: input element kinds of the C entry point
_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int32: 1}
#: elements each thread loads and stores at once (uchar4 / int4 vectors)
ITEMS = 4
_VEC_BYTES = {0: 4, 1: 16}          # kind -> bytes of one thread's load

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("prefix_scan")
    fn = lib.prefix_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_p, _p, _ll, _ll, _i, _i, _i, _p]
        fn.restype = _i
    return lib


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
    shape = x.shape
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    length = shape[-1]
    if out.numel() == 0:
        return out.zero_()
    x = x.contiguous()
    rows = x.numel() // length
    kind = _KINDS[x.dtype]
    # rows start on a vector boundary only when the base pointer does and
    # the row length is a multiple of ITEMS; otherwise the kernel loads and
    # stores element by element
    in_vec = int(x.data_ptr() % _VEC_BYTES[kind] == 0 and length % ITEMS == 0)
    out_vec = int(out.data_ptr() % 16 == 0 and length % ITEMS == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().prefix_scan_launch(x.data_ptr(), out.data_ptr(), rows, length,
                                    kind, in_vec, out_vec, stream)
    if err:
        raise RuntimeError(f"prefix_scan kernel launch failed: CUDA error {err}")
    prefix_scan.launches += 1
    return out


prefix_scan.launches = 0


def mask_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """:func:`prefix_scan` of a boolean mask; raises ``TypeError`` for any
    other dtype, as ``repro.kernels.prefix_scan.host.mask_cumsum`` does."""
    if mask.dtype != torch.bool:
        raise TypeError(f"mask_cumsum expects a boolean mask, got {mask.dtype}")
    return prefix_scan(mask)
