"""Vectorized request-arrival generators on the counter threefry stream.

One generator stands in for millions of users: it turns a timeline's
interval grid into an integer arrival count per interval.  Counts are
drawn by *inverting the Poisson CDF* against a uniform from the
``repro_torch.core.prng`` counter stream -- one threefry block per
``(seed, stream, interval)`` triple -- so a seeded spec reproduces
bit-identically everywhere: the host matrix is computed once in NumPy and
fed verbatim to both the NumPy and the torch serving engines (the same
host-mirror discipline as ``repro_torch.core.prng.counter_fault_masks``).
A copy of ``repro.slo.arrivals``: host float64 code.

Two shapes:

  * :class:`PoissonArrivals` -- stationary rate (requests/hour);
  * :class:`DiurnalArrivals` -- a 24-hour cosine load curve
    ``rate(t) = base * (1 + amplitude * cos(2*pi*(t - peak_h)/24))``,
    integrated per interval at the interval midpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import prng as cprng

#: Iteration ceiling of the CDF inversion: means above this would need
#: thousands of accumulation steps and lose float64 mass in the tail.
#: Split the stream (more arrival generators) or the intervals instead.
MAX_MEAN = 4096.0


def counter_uniforms(seed: int, stream: int, count: int) -> np.ndarray:
    """``count`` float64 uniforms in (0, 1) from the counter stream.

    Draw ``i`` depends only on ``(seed, stream, i)``: key
    ``fold_in(fold_in(seed_key, stream), i)`` hashed over a zero counter,
    mapped as ``(bits + 0.5) / 2**32`` -- strictly inside (0, 1) so the
    CDF inversion below never chases an exactly-1.0 target.
    """
    if count == 0:
        return np.zeros(0, dtype=np.float64)
    root = cprng.threefry_fold_in(cprng.threefry_seed(seed), stream)
    keys = cprng.threefry_fold_in_batch(
        root, np.arange(count, dtype=np.int64))
    x0 = np.zeros((count, 1), np.uint32)
    x1 = np.zeros((count, 1), np.uint32)
    tmp = np.empty_like(x0)
    cprng._threefry2x32_inplace(keys[:, :1], keys[:, 1:], x0, x1, tmp)
    return (x0[:, 0].astype(np.float64) + 0.5) / float(1 << 32)


def poisson_counts(means: np.ndarray, uniforms: np.ndarray) -> np.ndarray:
    """Poisson counts by CDF inversion, elementwise, int64.

    ``counts[i]`` is the smallest ``k`` with ``CDF_Poisson(means[i])(k) >=
    uniforms[i]`` -- pure float64 arithmetic with no library sampler, so
    the draw is a deterministic function of ``(mean, uniform)`` on every
    platform.  Means must be ``<= MAX_MEAN`` (raise otherwise).
    """
    means = np.asarray(means, dtype=np.float64)
    u = np.asarray(uniforms, dtype=np.float64)
    if means.shape != u.shape:
        raise ValueError(f"means {means.shape} != uniforms {u.shape}")
    if (means < 0).any():
        raise ValueError("negative Poisson mean")
    if (means > MAX_MEAN).any():
        raise ValueError(
            f"arrival mean per interval exceeds {MAX_MEAN}; split the "
            "stream or use shorter intervals")
    k = np.zeros(means.shape, dtype=np.int64)
    pmf = np.exp(-means)
    cdf = pmf.copy()
    # hard ceiling: beyond mean + 12*sqrt(mean) + 20 the remaining CDF mass
    # is below float64 resolution, so any still-pending uniform saturates
    kmax = means + 12.0 * np.sqrt(means) + 20.0
    pending = cdf < u
    while pending.any():
        k[pending] += 1
        pmf[pending] *= means[pending] / k[pending]
        cdf[pending] += pmf[pending]
        pending = (cdf < u) & (k < kmax)
    return k


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Stationary Poisson stream: ``rate_per_h`` requests/hour."""

    rate_per_h: float
    seed: int = 0
    stream: int = 0

    @property
    def label(self) -> str:
        return f"poisson-{self.rate_per_h:g}/h"

    def interval_means(self, edges_h: np.ndarray,
                       horizon_h: float) -> np.ndarray:
        durations = np.diff(np.append(np.asarray(edges_h, float), horizon_h))
        return self.rate_per_h * durations

    def counts(self, edges_h: np.ndarray, horizon_h: float) -> np.ndarray:
        """Integer arrivals per interval, shape ``(B,)``, int64."""
        means = self.interval_means(edges_h, horizon_h)
        u = counter_uniforms(self.seed, self.stream, means.size)
        return poisson_counts(means, u)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(PoissonArrivals):
    """Poisson stream with a 24-hour cosine load curve.

    ``rate(t) = rate_per_h * (1 + amplitude * cos(2*pi*(t - peak_h)/24))``
    evaluated at each interval's midpoint; ``amplitude`` in [0, 1] keeps
    the rate nonnegative.
    """

    amplitude: float = 0.5
    peak_h: float = 14.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], "
                             f"got {self.amplitude}")

    @property
    def label(self) -> str:
        return (f"diurnal-{self.rate_per_h:g}/h"
                f"-a{self.amplitude:g}")

    def interval_means(self, edges_h: np.ndarray,
                       horizon_h: float) -> np.ndarray:
        edges = np.asarray(edges_h, dtype=np.float64)
        ends = np.append(edges[1:], horizon_h)
        mid = 0.5 * (edges + ends)
        rate = self.rate_per_h * (
            1.0 + self.amplitude * np.cos(2.0 * np.pi
                                          * (mid - self.peak_h) / 24.0))
        return rate * (ends - edges)


__all__ = ["DiurnalArrivals", "MAX_MEAN", "PoissonArrivals",
           "counter_uniforms", "poisson_counts"]
