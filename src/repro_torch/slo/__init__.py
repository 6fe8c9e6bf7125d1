"""Serving-under-churn: batched SLO engine over the fault timeline.

Production traffic (``arrivals``) meets fault-shrunken capacity
(``capacity``) in an integer-exact interval scan (``engine``; on the card a
doubling scan in ``torch_backend``), with latency/SLO/goodput/dollar
reductions in ``tables``.  The counterpart of ``repro.slo``, with the
same exports.

Typical use::

    from repro_torch.slo import PoissonArrivals, ServeSpec, run_serve_sweep

    spec = ServeSpec(timeline=timeline, arrivals=(PoissonArrivals(40.0),))
    result = run_serve_sweep(spec)                  # torch on cuda
    result = run_serve_sweep(spec, device="cpu")    # the same scan on the CPU
"""

from .arrivals import (DiurnalArrivals, MAX_MEAN, PoissonArrivals,
                       counter_uniforms, poisson_counts)
from .capacity import interval_capacity
from .engine import (BACKENDS, ServeResult, ServeSpec, cohort_deadlines,
                     expire_cumulative, resolve_backend, run_serve_scalar,
                     run_serve_sweep)
from .tables import (AMORTIZE_H, request_outcomes, slo_table,
                     timeline_slo_table)

__all__ = [
    "AMORTIZE_H", "BACKENDS", "DiurnalArrivals", "MAX_MEAN",
    "PoissonArrivals", "ServeResult", "ServeSpec", "cohort_deadlines",
    "counter_uniforms", "expire_cumulative", "interval_capacity",
    "poisson_counts", "request_outcomes", "resolve_backend",
    "run_serve_scalar", "run_serve_sweep", "slo_table",
    "timeline_slo_table",
]
