"""Serving-under-churn engine: arrival streams vs fault-timeline capacity.

The counterpart of ``repro.slo.engine``.

One :class:`ServeSpec` drives a ``(arrival streams R x architectures A x
intervals B)`` grid: every timeline interval admits an integer number of
requests per stream (``repro_torch.slo.arrivals``, counter-threefry-seeded) and
can serve an integer request budget per architecture
(``repro_torch.slo.capacity`` -- faults shrink the ring, reconfiguration stalls
pause it, repairs restore it).  Requests are served FIFO and abandon when
their wait exceeds ``patience_h``.

The discrete dynamics are deliberately integer-exact.  With cohorts
ordered by interval, the FIFO queue of one cell is a *contiguous index
range*, so the whole cell state is a single counter ``G`` (requests gone:
served or abandoned), and one interval step is

    joined = cum_arrivals[s]
    k      = min(joined - G, capacity[s])        # serve the oldest k
    G     += k                                   # -> served_cum[s]
    G      = max(G, expire_cum[s])               # cohorts past patience
                                                 # abandon -> gone_cum[s]

where ``expire_cum[s]`` is the cumulative arrival count of the last cohort
whose deadline passed by interval ``s`` (precomputed host-side).  The
batched engines run this scan vectorized over all ``(R, A)`` cells --
NumPy in a B-step loop, torch as a doubling scan of the steps' clamp-shift
maps on ``device`` (``repro_torch.slo.torch_backend``) -- and are
bit-for-bit equal to :func:`run_serve_scalar`, the event-by-event
reference that pushes/pops every individual request through an explicit
FIFO deque (``tests/test_torch_slo.py`` pins the equality, and holds all
three to ``repro.slo``).

Because the three monotone cumulative grids (arrivals, ``served_cum``,
``gone_cum``) fully determine every request's fate, per-request latency
distributions are recovered *after* the scan by interval inversion
(``repro_torch.slo.tables.request_outcomes``) -- no per-request state is ever
materialized in the batched paths.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from .capacity import interval_capacity

if TYPE_CHECKING:   # annotation-only: a runtime import would cycle back
    from ..churn.timeline import ChurnTimeline   # churn -> sim -> slo

BACKENDS = ("numpy", "torch")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One serving-under-churn experiment: arrival streams x timeline."""

    timeline: ChurnTimeline
    arrivals: Tuple                      # arrival generators (rate axis)
    tp: Optional[int] = None             # timeline TP column (default first)
    req_per_gpu_hour: float = 1.0        # serving throughput per placed GPU
    slo_h: float = 1.0                   # wait SLO threshold (hours)
    patience_h: float = 4.0              # abandonment threshold (hours)
    reconfig_pause: bool = True          # charge ReconfigRecord stalls

    def __post_init__(self):
        object.__setattr__(self, "arrivals", tuple(self.arrivals))
        if not self.arrivals:
            raise ValueError("ServeSpec needs at least one arrival stream")
        if self.patience_h < 0 or self.slo_h < 0:
            raise ValueError("slo_h and patience_h must be >= 0")

    @property
    def tp_size(self) -> int:
        return int(self.tp) if self.tp is not None \
            else int(self.timeline.tp_sizes[0])

    def arrival_matrix(self) -> np.ndarray:
        """Integer arrivals per ``(stream, interval)`` cell, int64."""
        tl = self.timeline
        return np.stack([np.asarray(g.counts(tl.edges_h, tl.horizon_h),
                                    dtype=np.int64)
                         for g in self.arrivals])

    def capacity_matrix(self) -> np.ndarray:
        """Request budget per ``(architecture, interval)`` cell, int64."""
        return interval_capacity(self.timeline, tp=self.tp_size,
                                 req_per_gpu_hour=self.req_per_gpu_hour,
                                 reconfig_pause=self.reconfig_pause)


@dataclasses.dataclass
class ServeResult:
    """Grids of one serving sweep, axes ``(streams R, archs A, intervals B)``.

    ``served_cum``/``gone_cum`` are the monotone per-interval counters the
    latency inversion consumes (``gone_cum`` counts served + abandoned);
    ``pair_log`` is only attached by the scalar reference: its directly
    observed ``(r, a) -> {(cohort, interval, served): count}`` request log,
    which the tests compare against the batched inversion.
    """

    names: List[str]                 # architecture names, axis 1
    arrival_labels: List[str]        # stream labels, axis 0
    tp_size: int
    slo_h: float
    patience_h: float
    horizon_h: float
    total_gpus: np.ndarray           # (A,) cluster size at the TP column
    edges_h: np.ndarray              # (B,)
    arrivals: np.ndarray             # (R, B) int64
    capacity: np.ndarray             # (A, B) int64
    served: np.ndarray               # (R, A, B) int64
    abandoned: np.ndarray            # (R, A, B) int64
    queue_depth: np.ndarray          # (R, A, B) int64, end of interval
    served_cum: np.ndarray           # (R, A, B) int64
    gone_cum: np.ndarray             # (R, A, B) int64
    backend: str = "numpy"
    pair_log: Optional[Dict] = None

    @property
    def ends_h(self) -> np.ndarray:
        return np.append(self.edges_h[1:], self.horizon_h)

    @property
    def durations_h(self) -> np.ndarray:
        return np.diff(np.append(self.edges_h, self.horizon_h))

    @property
    def total_arrivals(self) -> np.ndarray:
        return self.arrivals.sum(axis=1)                         # (R,)

    @property
    def leftover(self) -> np.ndarray:
        """Requests still queued at the horizon, ``(R, A)``."""
        return self.total_arrivals[:, None] - self.gone_cum[:, :, -1]

    def index(self, name: str) -> int:
        return self.names.index(name)


# ------------------------------------------------------------ precompute

def cohort_deadlines(edges_h: np.ndarray, horizon_h: float,
                     patience_h: float) -> np.ndarray:
    """Last interval each cohort is willing to be served in, ``(B,)`` int64.

    Cohort ``b`` arrives at ``edges_h[b]`` and tolerates completion up to
    ``edges_h[b] + patience_h``; service completes at interval *ends*, so
    its deadline is the last interval whose end fits -- never before its
    own arrival interval (a request always waits that one out).  A cohort
    whose patience outlives the horizon gets the sentinel ``B`` (it never
    abandons; unresolved requests count as *leftover*, not abandoned).
    Nondecreasing by construction, which is what keeps the FIFO queue a
    contiguous range.
    """
    edges = np.asarray(edges_h, dtype=np.float64)
    ends = np.append(edges[1:], horizon_h)
    raw = np.searchsorted(ends, edges + patience_h, side="right") - 1
    dead = np.maximum(raw, np.arange(edges.size)).astype(np.int64)
    dead[edges + patience_h > horizon_h] = edges.size
    return dead


def expire_cumulative(arrivals_cum: np.ndarray,
                      dead: np.ndarray) -> np.ndarray:
    """``expire_cum[r, s]``: arrivals through the last cohort whose
    deadline is ``<= s`` -- the abandonment floor of the scan."""
    B = dead.size
    idx = np.searchsorted(dead, np.arange(B), side="right") - 1   # (B,)
    exp = np.zeros(arrivals_cum.shape, dtype=np.int64)
    has = idx >= 0
    exp[:, has] = arrivals_cum[:, idx[has]]
    return exp


def _prepared(spec: ServeSpec):
    arr = spec.arrival_matrix()                                   # (R, B)
    cap = spec.capacity_matrix()                                  # (A, B)
    if arr.shape[1] != cap.shape[1]:
        raise ValueError(f"arrival intervals {arr.shape[1]} != timeline "
                         f"intervals {cap.shape[1]}")
    ca = np.cumsum(arr, axis=1)
    dead = cohort_deadlines(spec.timeline.edges_h,
                            spec.timeline.horizon_h, spec.patience_h)
    expire = expire_cumulative(ca, dead)
    return arr, cap, ca, expire


def _result(spec: ServeSpec, arr, cap, grids, backend: str,
            pair_log=None) -> ServeResult:
    served, served_cum, gone_cum, queue = grids
    tl = spec.timeline
    return ServeResult(
        names=list(tl.names),
        arrival_labels=[g.label for g in spec.arrivals],
        tp_size=spec.tp_size, slo_h=spec.slo_h,
        patience_h=spec.patience_h,
        horizon_h=tl.horizon_h,
        total_gpus=np.asarray(
            tl.total_gpus[:, tl.tp_index(spec.tp_size)], dtype=np.int64),
        edges_h=np.asarray(spec.timeline.edges_h, dtype=np.float64),
        arrivals=arr, capacity=cap, served=served,
        abandoned=gone_cum - served_cum, queue_depth=queue,
        served_cum=served_cum, gone_cum=gone_cum, backend=backend,
        pair_log=pair_log)


# --------------------------------------------------------------- engines

def _scan_numpy(ca: np.ndarray, cap: np.ndarray,
                expire: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The interval scan, vectorized over all (R, A) cells; int64."""
    R, B = ca.shape
    A = cap.shape[0]
    shape = (R, A, B)
    served = np.empty(shape, np.int64)
    served_cum = np.empty(shape, np.int64)
    gone_cum = np.empty(shape, np.int64)
    queue = np.empty(shape, np.int64)
    G = np.zeros((R, A), np.int64)
    tel = obs.enabled()
    for s in range(B):
        joined = ca[:, s][:, None]                               # (R, 1)
        k = np.minimum(joined - G, cap[None, :, s])
        G = G + k
        served[:, :, s] = k
        served_cum[:, :, s] = G
        np.maximum(G, expire[:, s][:, None], out=G)
        gone_cum[:, :, s] = G
        queue[:, :, s] = joined - G
        if tel:
            obs.gauge("slo.queue_depth", int(queue[:, :, s].max()))
    return served, served_cum, gone_cum, queue


def _scan_scalar(ca: np.ndarray, arr: np.ndarray, cap: np.ndarray,
                 dead: np.ndarray) -> Tuple[Tuple[np.ndarray, ...], Dict]:
    """Event-by-event reference: every request is an explicit FIFO entry.

    Returns the same four grids as the batched scan plus the per-cell
    ``{(cohort, interval, served): count}`` request log -- the ground
    truth the latency inversion is validated against.
    """
    from collections import Counter, deque
    R, B = ca.shape
    A = cap.shape[0]
    shape = (R, A, B)
    served = np.zeros(shape, np.int64)
    served_cum = np.zeros(shape, np.int64)
    gone_cum = np.zeros(shape, np.int64)
    queue = np.zeros(shape, np.int64)
    pair_log: Dict = {}
    for r in range(R):
        for a in range(A):
            q = deque()
            pairs = Counter()
            gone = 0
            for s in range(B):
                for _ in range(int(arr[r, s])):
                    q.append(s)
                budget = int(cap[a, s])
                n_serve = min(len(q), budget)
                for _ in range(n_serve):
                    pairs[(q.popleft(), s, True)] += 1
                gone += n_serve
                served[r, a, s] = n_serve
                served_cum[r, a, s] = gone
                while q and dead[q[0]] <= s:
                    pairs[(q.popleft(), s, False)] += 1
                    gone += 1
                gone_cum[r, a, s] = gone
                queue[r, a, s] = len(q)
            pair_log[(r, a)] = dict(pairs)
    return (served, served_cum, gone_cum, queue), pair_log


def resolve_backend(backend: Optional[str]) -> str:
    """Resolve ``backend`` ("auto"/None reads ``REPRO_SWEEP_BACKEND``).

    ``auto`` is ``torch``, as in the port's DCN engine: the serve scan has
    no per-architecture kernels, only the shared integer recurrence.
    Which device it runs on is the caller's ``device`` argument, never
    chosen here.
    """
    if backend in (None, "auto"):
        backend = os.environ.get("REPRO_SWEEP_BACKEND", "auto") \
            .strip().lower() or "auto"
        if backend not in ("auto",) + BACKENDS:
            raise ValueError(
                f"REPRO_SWEEP_BACKEND={backend!r} (want numpy|torch|auto)")
        return "torch" if backend == "auto" else backend
    if backend in BACKENDS:
        return backend
    raise ValueError(f"unknown backend {backend!r} (numpy|torch|auto)")


def run_serve_sweep(spec: ServeSpec, backend: Optional[str] = None,
                    device="cuda") -> ServeResult:
    """Run the batched serving sweep; grids bit-for-bit identical across
    backends and to :func:`run_serve_scalar`.  ``device`` is where the
    torch backend runs: ``cuda`` unless the caller passes ``"cpu"``, and
    it raises without a card."""
    chosen = resolve_backend(backend)
    arr, cap, ca, expire = _prepared(spec)
    with obs.span("slo.run_serve_sweep", backend=chosen,
                  streams=arr.shape[0], arches=cap.shape[0],
                  intervals=arr.shape[1]) as sp:
        if chosen == "torch":
            from . import torch_backend
            grids = torch_backend.serve_scan(ca, cap, expire, device)
        else:
            grids = _scan_numpy(ca, cap, expire)
        res = _result(spec, arr, cap, grids, chosen)
        obs.count("slo.requests_served", int(res.served.sum()))
        obs.count("slo.requests_abandoned", int(res.abandoned.sum()))
        obs.gauge("slo.max_queue_depth", int(res.queue_depth.max())
                  if res.queue_depth.size else 0)
        sp.set(requests=int(res.total_arrivals.sum()))
    return res


def run_serve_scalar(spec: ServeSpec) -> ServeResult:
    """Event-by-event reference (slow): the semantic anchor of the sweep."""
    arr, cap, ca, _ = _prepared(spec)
    dead = cohort_deadlines(spec.timeline.edges_h,
                            spec.timeline.horizon_h, spec.patience_h)
    with obs.span("slo.run_serve_scalar", streams=arr.shape[0],
                  arches=cap.shape[0], intervals=arr.shape[1]):
        grids, pair_log = _scan_scalar(ca, arr, cap, dead)
    return _result(spec, arr, cap, grids, "scalar", pair_log=pair_log)


__all__ = [
    "BACKENDS", "ServeResult", "ServeSpec", "cohort_deadlines",
    "expire_cumulative", "resolve_backend", "run_serve_scalar",
    "run_serve_sweep",
]
