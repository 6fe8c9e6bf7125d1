"""Structured fault-scenario generators (counter-threefry seeded).

One contract for every generator (:mod:`repro_torch.faults.base`): a
seeded integer-tick grid whose NumPy and torch mask streams are
bit-identical, emitted both as a batched Snapshots source
(``masks(num_nodes)`` for the ``repro_torch.sim``/``repro_torch.dcn``/
``repro_torch.cost`` grid engines, or ``torch_masks(num_nodes)`` on a
device) and as a :class:`repro_torch.core.trace.FaultTrace`
(``trace(num_nodes)`` for the ``repro_torch.churn``/``repro_torch.slo``
replay engines).  The counterpart of ``repro.faults``, with the same
exports.

Typical use::

    from repro_torch.faults import CorrelatedTorOutages

    gen = CorrelatedTorOutages(samples=336, seed=11)
    masks = gen.masks(192)                        # NumPy, (336, 192)
    on_card = gen.torch_masks(192)                # the same grid on cuda
    trace = gen.trace(192)                        # for the churn replays
"""

from .base import (NumpyDraw, StructuredScenario, bernoulli, masks_to_trace,
                   trunc_geometric, trunc_geometric_mean, uniform_int,
                   wrap_occupancy)
from .generators import (BurstStorms, CorrelatedTorOutages,
                         FlappingStragglers, MaintenanceWindows)

#: The shipped family, in benchmark order.
GENERATORS = (CorrelatedTorOutages, MaintenanceWindows, BurstStorms,
              FlappingStragglers)

__all__ = [
    "StructuredScenario", "NumpyDraw", "bernoulli", "uniform_int",
    "trunc_geometric", "trunc_geometric_mean", "wrap_occupancy",
    "masks_to_trace", "CorrelatedTorOutages", "MaintenanceWindows",
    "BurstStorms", "FlappingStragglers", "GENERATORS",
]
