"""torch mirror of the ``repro_torch.core.prng`` threefry-2x32 stream.

The counterpart of ``repro.faults.jax_mirror``.  The structured generators
(:mod:`repro_torch.faults.generators`) derive every mask from uint32
threefry draws followed by pure integer/boolean arithmetic, so a torch
backend only needs the *draws* to match bit-for-bit -- the shared grid
code then runs unchanged on :class:`TorchOps`.  This module provides
that: :func:`threefry_bits_torch` reproduces
``repro_torch.core.prng.threefry_bits(key, size)`` (the original,
non-partitionable counter layout, not the per-row layout of
``counter_masks_at``) on a device, and :class:`TorchDraw` wires it behind
the same named-sub-stream interface as
:class:`repro_torch.faults.base.NumpyDraw`.

torch has no CPU add or shift for ``uint32``, so the cipher runs through
``repro_torch.core.prng.threefry2x32_torch`` on int64 lanes holding
uint32 values; ``bits < threshold`` and ``bits % n`` on those lanes give
the uint32 results.  Key derivation (seed + fold_in) is a handful of
host-side scalar hashes and reuses the NumPy mirror directly.  ``cuda``
without a card raises, as every entry point of the port does.
"""

from __future__ import annotations

import torch

from ..core.prng import threefry2x32_torch, threefry_fold_in, threefry_seed
from ..sim.torch_backend import _device


def threefry_bits_torch(key, size: int, device="cuda") -> torch.Tensor:
    """``repro_torch.core.prng.threefry_bits(key, size)`` (original layout)
    as an int64 tensor of uint32 values on ``device``; ``key`` is the
    host-side 2-word uint32 key.

    The flat counter ``0..size-1`` is padded with one zero when ``size``
    is odd and split in halves ``c0 = count[:half]``, ``c1 =
    count[half:]``; the output is ``concat(x0, x1)[:size]``.
    """
    dev = _device(device)
    if size == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    odd = size % 2
    count = torch.arange(size + odd, dtype=torch.int64, device=dev)
    if odd:
        count[size] = 0                    # the NumPy mirror pads one zero
    half = (size + odd) // 2
    x0, x1 = threefry2x32_torch(int(key[0]), int(key[1]), count[:half],
                                count[half:])
    return torch.cat([x0, x1])[:size]


class TorchDraw:
    """Named threefry sub-streams on a device: ``bits(stream, shape)`` is
    bit-identical to :class:`repro_torch.faults.base.NumpyDraw` for the
    same seed (key chain folded host-side, lanes hashed with torch)."""

    def __init__(self, seed: int, device="cuda"):
        self.device = _device(device)
        self._root = threefry_seed(seed)

    def bits(self, stream: int, shape) -> torch.Tensor:
        if isinstance(shape, int):
            shape = (shape,)
        size = 1
        for dim in shape:
            size *= int(dim)
        key = threefry_fold_in(self._root, stream)
        return threefry_bits_torch(key, size, self.device).reshape(shape)


class TorchOps:
    """:class:`repro_torch.faults.base.NumpyOps` on a torch device.

    Integer results are int32 (``cumsum``/``cumprod`` take the dtype
    explicitly: torch widens integer scans to int64 otherwise), draws are
    int64 lanes of uint32 values, and ``mod``/``floordiv`` round toward
    minus infinity as NumPy's ``%`` and ``//`` do.
    """

    def __init__(self, device="cuda"):
        self.device = _device(device)

    def arange(self, n: int):
        return torch.arange(n, dtype=torch.int32, device=self.device)

    def zeros(self, shape):
        return torch.zeros(tuple(shape), dtype=torch.bool, device=self.device)

    def ones(self, shape):
        return torch.ones(tuple(shape), dtype=torch.bool, device=self.device)

    def int32(self, x):
        return x.to(torch.int32)

    def mod(self, x, n: int):
        return torch.remainder(x, n)

    def floordiv(self, x, n: int):
        return torch.div(x, n, rounding_mode="floor")

    def where(self, cond, x, y):
        return torch.where(cond, x, y)

    def cumsum(self, x, axis: int):
        return torch.cumsum(x, dim=axis, dtype=torch.int32)

    def cumprod(self, x, axis: int):
        return torch.cumprod(x, dim=axis, dtype=torch.int32)

    def sum(self, x, axis: int):
        return x.sum(dim=axis)

    def any(self, x, axis: int):
        return x.any(dim=axis)

    def repeat(self, x, n: int, axis: int):
        return torch.repeat_interleave(x, n, dim=axis)

    def concatenate(self, xs, axis: int):
        return torch.cat(list(xs), dim=axis)


__all__ = ["TorchDraw", "TorchOps", "threefry_bits_torch"]
