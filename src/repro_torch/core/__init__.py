"""InfiniteHBD core of the port: topology, OCSTrx, orchestration, simulators.

Copies of the NumPy-only modules of ``repro.core`` (``ocstrx``,
``topology``, ``orchestrator``, ``hbd_models``, ``fault_sim``, ``trace``,
``reductions``, ``cost_model``, ``mfu_sim``, ``arch``, ``control_plane``
and ``placement``, whose ``make_orchestrated_mesh`` builds a
``torch.distributed`` ``DeviceMesh``), plus the torch threefry draw in
``prng``; it exports what ``repro.core`` exports.
"""

from .ocstrx import OCSTrx, OCSTrxBundle, Path
from .topology import KHopRingTopology, TopologyConfig
from .orchestrator import (IncrementalOrchestrator, Placement,
                           cross_tor_traffic, deployment_strategy,
                           greedy_baseline, healthy_components,
                           orchestrate_dcn_free, orchestrate_fat_tree,
                           placement_fat_tree)
from .placement import (InsufficientCapacityError, MeshPlan,
                        make_orchestrated_mesh, plan_mesh, ring_adjacency_ok)
from .hbd_models import (BatchedWasteResult, BigSwitch, HBDModel,
                         InfiniteHBDModel, NVLModel, SiPRingModel, TPUv4Model,
                         WasteResult, default_suite)
from .fault_sim import (fault_waiting_time, fault_waiting_time_batched,
                        max_job_scale, max_job_scale_batched,
                        theoretical_waste_bound, trace_grid, waste_over_trace,
                        waste_over_trace_batched, waste_vs_fault_ratio,
                        waste_vs_fault_ratio_batched)
from .trace import (FaultEvent, FaultTrace, generate_trace, iid_fault_masks,
                    iid_fault_sets, to_4gpu_trace)
from .cost_model import (ALL_BOMS, ArchBOM, Component, INFINITEHBD_K2,
                         INFINITEHBD_K3, NVL36, NVL72, NVL576, TPUV4,
                         aggregate_cost, cost_ratio, table6)
from .mfu_sim import (Cluster, GPT_MOE_1T, LLAMA31_405B, ParallelPlan,
                      SimModel, SimResult, search, simulate)
from .control_plane import (ClusterManager, ControlPlaneConfig,
                            NodeFabricManager, ReconfigEvent)
