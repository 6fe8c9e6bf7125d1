"""Rail-only architecture (Wang et al., arXiv 2307.12169).

The rail-only design keeps GPUs in large switched high-bandwidth domains
(~256 GPUs behind a full-bisection NVLink-class fabric) and connects the
domains only through per-rank "rail" links that carry no tensor-parallel
traffic -- TP groups must fit inside one HB domain.  For the waste model
that makes a rail-only cluster a set of independent 256-GPU islands with
no optical re-splicing and no reserved hot spares: a fault strands the
``avail mod tp`` fragment of its island only.

Modeling assumptions (the retrieved abstract gives no per-part BOM):

  * HB-domain size 256 GPUs -- the paper's "HB domain of GH200-256 scale";
  * no spare reservation (the design argues for buying fewer, larger
    domains rather than hot spares);
  * the interconnect BOM prices one 256-GPU domain with NVL-class
    hardware scaled from the paper's Table 8 NVL-72 row (same per-GPU
    switch and cable counts), i.e. $9563.20/GPU -- a *documented
    extension*, pinned by ``tests/test_registry.py`` so silent edits
    cannot drift the comparison matrix;
  * placement is island-granular (``dgx-island`` DCN variant): the rails
    carry DP traffic only, so TP groups never cross a ToR but DP pairs do.
"""

from __future__ import annotations

from ..core.arch import ArchSpec, register
from ..core.cost_model import ArchBOM, Component
from ..core.hbd_models import NVLModel

HB_GPUS = 256


class RailOnlyModel(NVLModel):
    """Rail-only waste model: 256-GPU switched islands, no spares.

    Inherits the island kernels (scalar + batched NumPy) from
    :class:`~repro_torch.core.hbd_models.NVLModel` -- the rail-only HB domain
    *is* a switch-centric island, just bigger and spare-free -- so the
    bit-exactness guarantees carry over unchanged.
    """

    name = "rail-only"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4,
                 hb_gpus: int = HB_GPUS):
        super().__init__(num_nodes, gpus_per_node, hbd_gpus=hb_gpus,
                         spare_fraction=0.0)
        self.name = "rail-only"


def _torch_kernel(model: RailOnlyModel, tps):
    """Device kernel: the NVL island kernel applies verbatim (deferred
    import keeps this module importable before repro_torch.sim)."""
    from ..sim.torch_backend import _nvl_kernel
    return _nvl_kernel(model, tps)


#: One 256-GPU rail-only HB domain, NVL-class hardware at Table-8 NVL-72
#: per-GPU part counts (64 NVLink switches, 72 DAC cables per switch).
RAIL_ONLY_BOM = ArchBOM("rail-only", gpus=HB_GPUS, per_gpu_bw_gbps=900.0,
                        components=[
    Component("NVLink switch", 64, 28000.0, 3600.0, 275.0),
    Component("DAC cable", 18432, 35.60, 25.0, 0.1),
])


register(ArchSpec(
    name="rail-only",
    factory=lambda n, g: RailOnlyModel(n, g),
    bom=RAIL_ONLY_BOM,
    torch_kernel=_torch_kernel,
    placement_variant="dgx-island",
    default_sweep=False,
    paper="Rail-only (arXiv 2307.12169)"))
