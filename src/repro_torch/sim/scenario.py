"""Scenario specifications for datacenter-scale fault sweeps.

A copy of ``repro.sim.scenario`` over the port's registry.

A :class:`ScenarioSpec` names the full evaluation grid of one experiment --
``snapshots x architectures x TP sizes`` -- declaratively, so sweeps are
reproducible from the spec alone (every random quantity is seeded).

Snapshot sources:

  * :class:`TraceSnapshots` -- sample a production-like fault trace
    (Appendix A generator, optionally Bayes-converted to 4-GPU nodes);
  * :class:`IIDSnapshots`   -- i.i.d. node faults at a fixed ratio
    (Fig. 14-style sweeps).

Architectures are referenced by registry name (``big-switch``,
``infinitehbd-k3``, ``nvl-72``, ``tpuv4``, ``sip-ring``, ...), matching the
``HBDModel.name`` attributes of the §6.1 evaluation suite.  The registry
itself lives in :mod:`repro_torch.core.arch` -- one :class:`~repro_torch.core.arch.\
ArchSpec` per architecture bundling the model factory, the BOM (or
unpriceable marker), the DCN placement hook and the device kernel --
``MODEL_REGISTRY`` here is a live name->factory view over it.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core import arch
from ..core.arch import ModelFactory, make_model  # noqa: F401 (re-export)
from ..core.hbd_models import HBDModel
from ..core.prng import counter_fault_masks
from ..core.trace import generate_trace, iid_fault_masks, to_4gpu_trace

#: Live read-only ``name -> factory`` view over the ``repro_torch.core.arch``
#: registry: architectures registered later (e.g. by external modules)
#: appear here without further wiring.
MODEL_REGISTRY: Mapping[str, ModelFactory] = arch.MODEL_FACTORIES

#: The default comparison suite, in registration (= §6.1 paper) order:
#: every architecture whose spec sets ``default_sweep=True``.  The DGX
#: island model and the rival-zoo architectures are registered for the
#: churn/MFU/matrix comparisons but opt out of default sweeps via that
#: registry attribute (``repro_torch.core.arch.ArchSpec.default_sweep``).
DEFAULT_ARCHITECTURES: Tuple[str, ...] = arch.default_architectures()


@dataclasses.dataclass(frozen=True)
class TraceSnapshots:
    """Snapshots sampled from an Appendix-A synthetic fault trace.

    ``trace_nodes`` (8-GPU nodes fed to the generator) defaults to whatever
    covers the swept cluster -- a trace narrower than the cluster would make
    the uncovered tail read permanently healthy.  Pass it explicitly to pin
    a specific trace (e.g. the paper's 400-node production-like one).
    """

    trace_nodes: Optional[int] = None
    samples: int = 400
    seed: int = 1
    horizon_h: float = 348 * 24.0
    convert_4gpu: bool = True       # apply the Appendix-A Bayes split

    def masks(self, num_nodes: int) -> np.ndarray:
        tn = self.trace_nodes
        if tn is None:
            tn = (num_nodes + 1) // 2 if self.convert_4gpu else num_nodes
        tr = generate_trace(tn, horizon_h=self.horizon_h, seed=self.seed)
        if self.convert_4gpu:
            tr = to_4gpu_trace(tr)
        return tr.fault_masks(tr.sample_times(self.samples))


@dataclasses.dataclass(frozen=True)
class IIDSnapshots:
    """I.i.d. snapshots at a fixed node-fault ratio (NumPy PCG64 stream)."""

    fault_ratio: float
    samples: int = 20
    seed: int = 0

    def masks(self, num_nodes: int) -> np.ndarray:
        return iid_fault_masks(num_nodes, self.fault_ratio, self.samples,
                               self.seed)


@dataclasses.dataclass(frozen=True)
class CounterIIDSnapshots:
    """I.i.d. snapshots from the counter-based threefry stream.

    Unlike :class:`IIDSnapshots` (NumPy PCG64), this source is
    seed-compatible across compute backends: snapshot ``i`` is drawn from
    ``fold_in(key(seed), i)``, so the torch backend regenerates the identical
    masks *on the device* (``repro_torch.core.prng.counter_masks_at``, never materializing a host
    matrix) while the NumPy backend uses the bit-exact mirror in
    :mod:`repro_torch.core.prng`.  Preferred for million-snapshot sweeps.
    """

    fault_ratio: float
    samples: int = 20
    seed: int = 0

    def masks(self, num_nodes: int) -> np.ndarray:
        return counter_fault_masks(num_nodes, self.fault_ratio, self.samples,
                                   self.seed)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One sweep: ``snapshots x architectures x tp_sizes`` on a cluster."""

    num_nodes: int
    snapshots: object                                  # TraceSnapshots | IID...
    tp_sizes: Tuple[int, ...] = (16, 32, 64)
    architectures: Tuple[str, ...] = DEFAULT_ARCHITECTURES
    gpus_per_node: int = 4

    def models(self) -> Sequence[HBDModel]:
        return [make_model(a, self.num_nodes, self.gpus_per_node)
                for a in self.architectures]
