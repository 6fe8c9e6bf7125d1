"""torch compute backend for the serving scan: a doubling scan of
clamp-shift maps over the interval axis.

The counterpart of ``repro.slo.jax_backend``.  The interval recurrence of
``repro_torch.slo.engine`` advances one integer state ``G`` (requests gone:
served or abandoned) per ``(stream R, architecture A)`` cell:

    G_s = max(min(G_{s-1} + cap_s, joined_s), expire_s)

with ``joined_s`` the cumulative arrivals, ``cap_s`` the interval's budget
and ``expire_s`` the abandonment floor.  ``expire_s <= joined_s`` always
holds (a cohort's deadline is never before its own interval), so step
``s`` is the clamp-shift map ``x -> clamp(x + c, lo, hi)`` with ``lo <=
hi``, and such maps compose in closed form::

    (c2, lo2, hi2) o (c1, lo1, hi1)
        = (c1 + c2, clamp(lo1 + c2, lo2, hi2), clamp(hi1 + c2, lo2, hi2))

A Hillis-Steele doubling scan over the interval axis therefore yields the
prefix map of every interval in ``ceil(log2 B)`` passes of int64
elementwise ops on the device -- 11 at 1,342 intervals, 16 at 37,791 --
instead of one launch group per interval.  The arithmetic is integer
min/max/add, so the grids are bit-for-bit those of ``_scan_numpy``
(``tests/test_torch_slo.py``).

As in ``repro``, total arrivals per stream must stay below ``2**31`` (an
``OverflowError`` otherwise) and the capacity driver is clipped to that
total (a budget beyond every outstanding request never binds), so the
sums of clipped budgets stay below ``B * 2**31``, far inside int64.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import obs
from ..sim.torch_backend import _device

_INT32_MAX = np.int64(2**31 - 1)


def _clamp(x: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor) -> torch.Tensor:
    return torch.maximum(torch.minimum(x, hi), lo)


def prefix_maps(cap: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Inclusive composition of the clamp-shift maps along the last axis.

    ``cap`` is ``(A, B)``, ``lo``/``hi`` are ``(R, 1, B)``; returns ``(C,
    L, H)`` of shapes ``(A, B)``, ``(R, A, B)``, ``(R, A, B)`` such that
    the maps of intervals ``0..s`` applied in order send ``x`` to
    ``clamp(x + C[..., s], L[..., s], H[..., s])``.
    """
    B = cap.shape[-1]
    c = cap
    lo = lo.expand(lo.shape[0], cap.shape[0], B)
    hi = hi.expand(hi.shape[0], cap.shape[0], B)
    d = 1
    while d < B:
        # position i (>= d) takes the segment ending at i - d first, then
        # its own: (c_i, lo_i, hi_i) o (c_{i-d}, lo_{i-d}, hi_{i-d})
        c_i, lo_i, hi_i = c[..., d:], lo[..., d:], hi[..., d:]
        c = torch.cat([c[..., :d], c_i + c[..., :-d]], dim=-1)
        lo, hi = (torch.cat([lo[..., :d], _clamp(lo[..., :-d] + c_i, lo_i, hi_i)], dim=-1),
                  torch.cat([hi[..., :d], _clamp(hi[..., :-d] + c_i, lo_i, hi_i)], dim=-1))
        d *= 2
    return c, lo, hi


def serve_scan(ca: np.ndarray, cap: np.ndarray, expire: np.ndarray,
               device="cuda") -> Tuple[np.ndarray, ...]:
    """Run the serving scan on ``device``; returns int64
    ``(served, served_cum, gone_cum, queue)``, each ``(R, A, B)``."""
    dev = _device(device)
    ca = np.asarray(ca, np.int64)
    cap = np.asarray(cap, np.int64)
    expire = np.asarray(expire, np.int64)
    total = ca[:, -1].max() if ca.size else 0
    if total > _INT32_MAX:
        raise OverflowError(
            f"total arrivals per stream ({total}) exceed 2**31 - 1; split "
            "the streams or use backend='numpy'")
    # budgets beyond every outstanding request never bind: clip so the
    # prefix sums of budgets stay far inside int64
    cap = np.minimum(cap, total)
    R, B = ca.shape
    A = cap.shape[0]
    if B == 0:
        empty = np.zeros((R, A, 0), np.int64)
        return empty, empty.copy(), empty.copy(), empty.copy()
    with obs.span("slo.torch.serve_scan", streams=R, arches=A, intervals=B,
                  device=str(dev)):
        joined = torch.from_numpy(ca).to(dev)[:, None, :]           # (R, 1, B)
        cap_t = torch.from_numpy(cap).to(dev)                       # (A, B)
        exp_t = torch.from_numpy(expire).to(dev)[:, None, :]        # (R, 1, B)
        C, L, H = prefix_maps(cap_t, exp_t, joined)
        gone = _clamp(C.expand_as(L), L, H)                         # G_s
        prev = torch.nn.functional.pad(gone[..., :-1], (1, 0))      # G_{s-1}
        served_cum = torch.minimum(joined, prev + cap_t)
        grids = (served_cum - prev, served_cum, gone, joined - gone)
        grids = tuple(g.cpu().numpy() for g in grids)
    obs.count("slo.torch.scans")
    return grids


__all__ = ["prefix_maps", "serve_scan"]
