"""UB-Mesh architecture (Huawei, arXiv 2503.20377).

UB-Mesh is a hierarchically localized nD-FullMesh datacenter network:
GPUs inside a rack form a dense electrical full-mesh (every node directly
linked to every other), and racks are themselves meshed at the next
hierarchy level -- cheap short-reach electrical links carry the heavy
local traffic, leaving only thin inter-rack capacity.

Waste model (documented extension; the retrieved abstract gives topology
intent, not algorithms): within a ``mesh_gpus``-GPU rack full-mesh, any
healthy GPU can reach any other at full bandwidth, so for TP groups that
fit inside a rack the waste is pure ``avail mod tp`` fragmentation -- no
hot spares (unlike NVL-36/72) and no sub-block poisoning (unlike TPUv4's
cube carving).  TP groups *larger* than a rack must span the sparse
inter-rack mesh, which cannot re-splice around intra-rack faults, so
scheduling falls back to whole-healthy-rack unions (TPUv4-style
coarse granularity):

    tp <= mesh_gpus:  placed = sum over racks of (healthy_gpus // tp) * tp
    tp  > mesh_gpus:  placed = (healthy_racks * mesh_gpus // tp) * tp

Scalar reference, batched NumPy kernel and torch device kernel implement
exactly this arithmetic, so the registry's bit-exactness gates apply
unchanged.  The BOM prices one 64-GPU (16-node) rack mesh: 120 node-pair
ACC cables (the 16-node full mesh) plus 16 inter-rack DAC (1.6T) uplinks,
Table-8 unit prices -- $649.90/GPU, pinned by ``tests/test_ub_mesh.py``.
"""

from __future__ import annotations

from typing import Sequence, Set

import numpy as np

from ..core.arch import ArchSpec, register
from ..core.cost_model import ArchBOM, Component
from ..core.hbd_models import BatchedWasteResult, HBDModel, WasteResult

MESH_GPUS = 64


class UBMeshModel(HBDModel):
    """Rack-level full-mesh islands; whole-rack unions above rack size."""

    name = "ub-mesh"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4,
                 mesh_gpus: int = MESH_GPUS):
        super().__init__(num_nodes, gpus_per_node)
        self.mesh_gpus = mesh_gpus

    def _static_config(self):
        return (self.mesh_gpus,)

    def _geometry(self):
        npn = self.mesh_gpus // self.gpus_per_node
        n_racks = self.num_nodes // npn
        return npn, n_racks, n_racks * npn

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        npn, n_racks, modeled = self._geometry()
        g = self.gpus_per_node
        placed = 0
        healthy_racks = 0
        for r in range(n_racks):
            lo = r * npn
            f_gpus = sum(g for u in range(lo, lo + npn) if u in faults)
            if f_gpus == 0:
                healthy_racks += 1
            if tp_size <= self.mesh_gpus:
                avail = self.mesh_gpus - f_gpus
                placed += (avail // tp_size) * tp_size
        if tp_size > self.mesh_gpus:
            placed = (healthy_racks * self.mesh_gpus // tp_size) * tp_size
        faulty = self._faulty_gpus({u for u in faults if u < modeled})
        return WasteResult(n_racks * self.mesh_gpus, faulty, placed)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        npn, n_racks, modeled = self._geometry()
        g = self.gpus_per_node
        snaps = masks.shape[0]
        racks = masks[:, :modeled].reshape(snaps, n_racks, npn)
        f_gpus = racks.sum(axis=2, dtype=np.int64) * g            # (S, R)
        avail = self.mesh_gpus - f_gpus
        healthy_racks = (f_gpus == 0).sum(axis=1, dtype=np.int64)
        placed = np.zeros((snaps, len(tps)), dtype=np.int64)
        for ti, tp in enumerate(tps):
            tp = int(tp)
            if tp <= self.mesh_gpus:
                placed[:, ti] = ((avail // tp) * tp).sum(axis=1)
            else:
                placed[:, ti] = (healthy_racks * self.mesh_gpus // tp) * tp
        faulty = f_gpus.sum(axis=1)[:, None]
        total = np.full(len(tps), n_racks * self.mesh_gpus, dtype=np.int64)
        return BatchedWasteResult(tps, total,
                                  np.broadcast_to(faulty, placed.shape).copy(),
                                  placed)


def _torch_kernel(model: UBMeshModel, tps: Sequence[int]):
    """torch mirror of ``_batch_eval`` over a ``(rows, W)`` mask block
    (int32 on device, same contract as the builders in
    ``repro_torch.sim.torch_backend``)."""
    import torch

    from ..sim.torch_backend import _clip
    npn, n_racks, modeled = model._geometry()
    g = model.gpus_per_node
    mesh = model.mesh_gpus
    i32 = torch.int32

    def fn(masks):
        m = _clip(masks, model.num_nodes)
        racks = m[:, :modeled].reshape(m.shape[0], n_racks, npn)
        f_gpus = racks.sum(dim=2, dtype=i32) * g
        avail = mesh - f_gpus
        healthy_racks = (f_gpus == 0).sum(dim=1, dtype=i32)
        placed = []
        for tp in tps:
            tp = int(tp)
            if tp <= mesh:
                placed.append(((avail // tp) * tp).sum(dim=1, dtype=i32))
            else:
                placed.append((healthy_racks * mesh // tp) * tp)
        placed = torch.stack(placed, dim=1)
        return f_gpus.sum(dim=1, dtype=i32)[:, None].expand_as(placed), placed
    return fn


#: One 64-GPU (16-node) rack: the 16-choose-2 intra-rack ACC full mesh
#: plus 16 inter-rack DAC (1.6T) uplinks, Table-8 unit prices.
UB_MESH_BOM = ArchBOM("ub-mesh", gpus=64, per_gpu_bw_gbps=800.0, components=[
    Component("ACC cable", 120, 320.0, 200.0, 2.5),
    Component("DAC cable (1.6T)", 16, 199.60, 200.0, 0.1),
])


register(ArchSpec(
    name="ub-mesh",
    factory=lambda n, g: UBMeshModel(n, g),
    bom=UB_MESH_BOM,
    torch_kernel=_torch_kernel,
    placement_variant="dgx-island",
    default_sweep=False,
    paper="UB-Mesh (arXiv 2503.20377)"))
