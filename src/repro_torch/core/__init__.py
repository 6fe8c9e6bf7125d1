"""InfiniteHBD core of the port: the pieces the sweep engine runs on.

Copies of the NumPy-only modules of ``repro.core`` (``prng``, ``trace``,
``reductions``, ``hbd_models``, ``cost_model``, ``arch`` and
``orchestrator.healthy_components``), plus the torch threefry draw in
``prng``.  Topology, OCSTrx, placement and the control plane come with
later slices.
"""

from .hbd_models import (BatchedWasteResult, BigSwitch, HBDModel,
                         InfiniteHBDModel, NVLModel, SiPRingModel, TPUv4Model,
                         WasteResult, default_suite)
from .orchestrator import healthy_components
from .trace import (FaultEvent, FaultTrace, generate_trace, iid_fault_masks,
                    iid_fault_sets, to_4gpu_trace)
from .cost_model import (ALL_BOMS, ArchBOM, Component, INFINITEHBD_K2,
                         INFINITEHBD_K3, NVL36, NVL72, NVL576, TPUV4,
                         aggregate_cost, cost_ratio, table6)
