"""Structured fault scenarios: one counter-threefry contract.

Every generator in :mod:`repro_torch.faults` describes node faults on a
regular *integer tick grid*: snapshot ``s`` is the cluster state during
``[s * tick_h, (s + 1) * tick_h)`` hours.  All randomness is uint32
threefry draws (:mod:`repro_torch.core.prng`) followed by pure
integer/boolean arithmetic -- modular starts, truncated-geometric
durations via cumprod of Bernoulli continue-bits, threshold comparisons --
so the NumPy and torch backends produce *bit-identical* mask streams from
one seed, exactly like ``CounterIIDSnapshots``; nothing ever hinges on
float rounding.

The counterpart of ``repro.faults.base``.  One ``_grid(num_nodes, xp,
draw)`` hook yields every emission; ``xp`` is an ops object that names
each array operation the generators use (:data:`NUMPY_OPS` here,
:class:`repro_torch.faults.torch_mirror.TorchOps` on a torch device), so
the four generators keep one code path where ``repro`` passes ``np`` or
``jnp``:

  * :meth:`StructuredScenario.masks` -- the batched ``(samples, nodes)``
    Snapshots source (duck-compatible with ``ScenarioSpec.snapshots``, so
    ``repro_torch.sim``/``repro_torch.dcn``/``repro_torch.cost`` grids
    consume it directly);
  * :meth:`StructuredScenario.torch_masks` -- the same grid computed with
    torch ops on a device and the :mod:`repro_torch.faults.torch_mirror`
    draws;
  * :meth:`StructuredScenario.trace` -- a
    :class:`repro_torch.core.trace.FaultTrace` built from the runs of
    consecutive faulty ticks, for ``repro_torch.churn``/``repro_torch.slo``
    replay.  The round trip is exact: ``trace(n).fault_masks(
    sample_times()) == masks(n)`` bit-for-bit (event edges are the same
    ``tick * tick_h`` float64 products the sample grid uses, so
    searchsorted recovers the tick indices).

Uniform integers are drawn as ``u32 % n``; the modulo bias is at most
``n / 2**32`` (~1e-7 for any grid here) and the analytic statistics the
generators advertise ignore it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import obs
from ..core.prng import (ratio_threshold, threefry_bits, threefry_fold_in,
                         threefry_seed)
from ..core.trace import FaultEvent, FaultTrace


class NumpyDraw:
    """Named threefry sub-streams: ``bits(stream, shape)`` draws an
    independent uint32 block per stream id (key = fold_in(seed, stream)),
    so generators can consume draws in any order without aliasing."""

    def __init__(self, seed: int):
        self._root = threefry_seed(seed)

    def bits(self, stream: int, shape) -> np.ndarray:
        if isinstance(shape, int):
            shape = (shape,)
        size = 1
        for dim in shape:
            size *= int(dim)
        key = threefry_fold_in(self._root, stream)
        return threefry_bits(key, size).reshape(shape)


class NumpyOps:
    """The array operations of the generators' grids, on NumPy.

    Integer results are int32 and masks bool, as in ``repro``'s NumPy
    path; ``mod`` and ``floordiv`` round toward minus infinity (NumPy's
    ``%`` and ``//``), which the maintenance schedule relies on before
    its phase.  :class:`repro_torch.faults.torch_mirror.TorchOps` has the
    same methods on a torch device.
    """

    def arange(self, n: int):
        return np.arange(n, dtype=np.int32)

    def zeros(self, shape):
        return np.zeros(shape, dtype=bool)

    def ones(self, shape):
        return np.ones(shape, dtype=bool)

    def int32(self, x):
        return x.astype(np.int32)

    def mod(self, x, n: int):
        return x % n

    def floordiv(self, x, n: int):
        return x // n

    def where(self, cond, x, y):
        return np.where(cond, x, y)

    def cumsum(self, x, axis: int):
        return np.cumsum(x, axis=axis, dtype=np.int32)

    def cumprod(self, x, axis: int):
        return np.cumprod(x, axis=axis, dtype=np.int32)

    def sum(self, x, axis: int):
        return x.sum(axis=axis)

    def any(self, x, axis: int):
        return x.any(axis=axis)

    def repeat(self, x, n: int, axis: int):
        return np.repeat(x, n, axis=axis)

    def concatenate(self, xs, axis: int):
        return np.concatenate(xs, axis=axis)


#: The NumPy ops every host emission uses.
NUMPY_OPS = NumpyOps()


def bernoulli(bits, ratio: float, xp):
    """``bits < round(ratio * 2**32)`` with the degenerate thresholds
    handled outside uint32 range (same convention as counter_fault_masks)."""
    thresh = ratio_threshold(ratio)
    if thresh >= (1 << 32):
        return xp.ones(bits.shape)
    if thresh <= 0:
        return xp.zeros(bits.shape)
    return bits < thresh            # 0 < thresh < 2**32 fits the draws' uint32


def uniform_int(bits, n: int, xp):
    """Uniform-ish integers in ``[0, n)`` via ``u32 % n`` (bias <= n/2**32)."""
    return xp.int32(xp.mod(bits, int(n)))


def trunc_geometric(bits, continue_p: float, xp):
    """Truncated-geometric lengths in ``[1, bits.shape[-1] + 1]``.

    ``bits[..., j]`` is the Bernoulli(continue_p) "survive tick j+1" draw;
    the length is ``1 + leading-run of continues`` (cumprod + sum), so
    ``P(len = 1+j) = p^j (1-p)`` for ``j < m`` and ``P(len = 1+m) = p^m``
    with ``m = bits.shape[-1]`` -- a memoryless decay with a hard cap.
    """
    cont = bernoulli(bits, continue_p, xp)
    ext = xp.sum(xp.cumprod(xp.int32(cont), -1), -1)
    return xp.int32(1 + ext)


def trunc_geometric_mean(continue_p: float, max_extra: int) -> float:
    """Analytic mean of :func:`trunc_geometric`: ``1 + sum_{j=1..m} p^j``."""
    p = float(continue_p)
    if p == 1.0:
        return 1.0 + max_extra
    return 1.0 + p * (1.0 - p ** max_extra) / (1.0 - p)


def wrap_occupancy(xp, ticks: int, starts, durs, active):
    """Occupancy of wraparound events on a circular tick grid.

    ``starts``/``durs`` are int32 ``(lanes, events)`` (durations must not
    exceed ``ticks``), ``active`` a matching bool mask; lane ``l`` is down
    at tick ``t`` iff some active event covers it circularly:
    ``(t - start) mod ticks < dur``.  Circular time makes the marginal
    exactly uniform -- P(an event slot covers any fixed tick) =
    ``p_active * E[dur] / ticks`` -- which is what the generators'
    analytic statistics rely on.  Returns bool ``(ticks, lanes)``.
    """
    t = xp.arange(ticks)[:, None, None]
    rel = xp.mod(t - starts[None], ticks)
    cov = active[None] & (rel < durs[None])
    return xp.any(cov, 2)


def masks_to_trace(masks: np.ndarray, tick_h: float) -> FaultTrace:
    """Convert a ``(samples, nodes)`` tick grid into a :class:`FaultTrace`.

    Each maximal run of consecutive faulty ticks ``[s0, s1]`` on a node
    becomes one event ``[s0 * tick_h, (s1 + 1) * tick_h)``; evaluating
    ``fault_masks`` back on the tick grid reproduces ``masks`` exactly.
    """
    masks = np.asarray(masks, dtype=bool)
    samples, num_nodes = masks.shape
    tick_h = float(tick_h)
    grid = np.zeros((num_nodes, samples + 2), dtype=np.int8)
    grid[:, 1:-1] = masks.T
    d = np.diff(grid, axis=1)                      # (nodes, samples + 1)
    n0, t0 = np.nonzero(d > 0)                     # run starts
    n1, t1 = np.nonzero(d < 0)                     # first tick after a run
    events: List[FaultEvent] = [
        FaultEvent(int(n), float(s) * tick_h, float(e) * tick_h)
        for n, s, e in zip(n0, t0, t1)]
    return FaultTrace(num_nodes=num_nodes, horizon_h=samples * tick_h,
                      events=events)


class StructuredScenario:
    """Base class: tick grid + seed + the three emissions."""

    label = "structured"

    def __init__(self, samples: int, tick_h: float = 1.0, seed: int = 0):
        if samples <= 0:
            raise ValueError("samples must be positive")
        if tick_h <= 0:
            raise ValueError("tick_h must be positive")
        self.samples = int(samples)
        self.tick_h = float(tick_h)
        self.seed = int(seed)

    @property
    def horizon_h(self) -> float:
        return self.samples * self.tick_h

    def sample_times(self) -> np.ndarray:
        """Tick left edges; ``trace(n).fault_masks(sample_times())`` equals
        ``masks(n)`` bit-for-bit."""
        return np.arange(self.samples) * self.tick_h

    def _grid(self, num_nodes: int, xp, draw):
        raise NotImplementedError

    def masks(self, num_nodes: int) -> np.ndarray:
        """The batched Snapshots emission (NumPy, ``(samples, nodes)``)."""
        with obs.span(f"faults.{self.label}.masks", samples=self.samples,
                      nodes=num_nodes):
            out = self._grid(int(num_nodes), NUMPY_OPS, NumpyDraw(self.seed))
        return np.asarray(out, dtype=bool)

    def torch_masks(self, num_nodes: int, device="cuda"):
        """The same grid as a bool tensor computed on ``device``
        (bit-identical); ``cuda`` without a card raises."""
        from .torch_mirror import TorchDraw, TorchOps
        ops = TorchOps(device)
        with obs.span(f"faults.{self.label}.torch_masks",
                      samples=self.samples, nodes=num_nodes,
                      device=str(ops.device)):
            return self._grid(int(num_nodes), ops,
                              TorchDraw(self.seed, ops.device))

    def trace(self, num_nodes: int) -> FaultTrace:
        """The replayable emission for ``repro_torch.churn`` /
        ``repro_torch.slo``."""
        return masks_to_trace(self.masks(num_nodes), self.tick_h)


__all__ = ["NumpyDraw", "NumpyOps", "NUMPY_OPS", "bernoulli", "uniform_int",
           "trunc_geometric", "trunc_geometric_mean", "wrap_occupancy",
           "masks_to_trace", "StructuredScenario"]
