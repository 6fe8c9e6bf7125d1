"""ACOS architecture (Technion, arXiv 2602.17449).

ACOS builds the HBD from *arrays of cheap small optical switches* instead
of one large OCS: each ``array_nodes``-node array interconnects its
members with full flexibility through a bank of small low-port-count
switches, and arrays exchange traffic over a thin budget of
``uplink_nodes`` trunk positions per array.

Waste model (documented extension; the retrieved abstract gives the
topology intent, not algorithms): inside an array any healthy GPU can
join any group, so array-fitting TP groups see pure ``avail mod tp``
fragmentation -- but the *remainders* of different arrays can be pooled
over the trunks, capped at ``uplink_nodes`` exported nodes per array:

    tp <= array_gpus:  placed = sum_d (h_d // tp) * tp
                                + (sum_d min(h_d mod tp, U*g)) // tp * tp
    tp  > array_gpus:  placed = (sum_d h_d) // tp * tp

with ``h_d`` the healthy GPUs of array ``d``, ``U = uplink_nodes`` and
``g`` GPUs per node.  Groups larger than an array ride spanning circuits
spliced through the trunks, so they pool all healthy capacity (the cheap
switches re-chain within each array) -- cheaper than a big switch but
bit-for-bit no better (the registry's lower-bound invariant).

The BOM prices one 128-GPU (32-node) array: 2 transceivers per node into
the switch bank, 8 cheap 32-port OCS units, and per-node fiber --
$553.40/GPU, pinned by ``tests/test_acos.py``.
"""

from __future__ import annotations

from typing import Sequence, Set

import numpy as np

from ..core.arch import ArchSpec, register
from ..core.cost_model import ArchBOM, Component
from ..core.hbd_models import BatchedWasteResult, HBDModel, WasteResult

ARRAY_NODES = 32
UPLINK_NODES = 8


class ACOSModel(HBDModel):
    """Cheap-switch arrays: free intra-array regrouping, capped remainder
    export over the inter-array trunks."""

    name = "acos"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4,
                 array_nodes: int = ARRAY_NODES,
                 uplink_nodes: int = UPLINK_NODES):
        super().__init__(num_nodes, gpus_per_node)
        self.array_nodes = array_nodes
        self.uplink_nodes = uplink_nodes

    def _static_config(self):
        return (self.array_nodes, self.uplink_nodes)

    def _geometry(self):
        n_arrays = self.num_nodes // self.array_nodes
        return n_arrays, n_arrays * self.array_nodes

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        n_arrays, modeled = self._geometry()
        g = self.gpus_per_node
        array_gpus = self.array_nodes * g
        cap = self.uplink_nodes * g
        placed = pool = total_healthy = 0
        for a in range(n_arrays):
            lo = a * self.array_nodes
            healthy = sum(1 for u in range(lo, lo + self.array_nodes)
                          if u not in faults)
            h_gpus = healthy * g
            total_healthy += h_gpus
            if tp_size <= array_gpus:
                q = (h_gpus // tp_size) * tp_size
                placed += q
                pool += min(h_gpus - q, cap)
        if tp_size <= array_gpus:
            placed += (pool // tp_size) * tp_size
        else:
            placed = (total_healthy // tp_size) * tp_size
        faulty = self._faulty_gpus({u for u in faults if u < modeled})
        return WasteResult(modeled * g, faulty, placed)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        n_arrays, modeled = self._geometry()
        g = self.gpus_per_node
        array_gpus = self.array_nodes * g
        cap = self.uplink_nodes * g
        snaps = masks.shape[0]
        arrays = masks[:, :modeled].reshape(snaps, n_arrays,
                                            self.array_nodes)
        f_nodes = arrays.sum(axis=2, dtype=np.int64)              # (S, A)
        h_gpus = (self.array_nodes - f_nodes) * g
        total_healthy = h_gpus.sum(axis=1)
        placed = np.zeros((snaps, len(tps)), dtype=np.int64)
        for ti, tp in enumerate(tps):
            tp = int(tp)
            if tp <= array_gpus:
                q = (h_gpus // tp) * tp
                pool = np.minimum(h_gpus - q, cap).sum(axis=1)
                placed[:, ti] = q.sum(axis=1) + (pool // tp) * tp
            else:
                placed[:, ti] = (total_healthy // tp) * tp
        faulty = (f_nodes.sum(axis=1) * g)[:, None]
        total = np.full(len(tps), modeled * g, dtype=np.int64)
        return BatchedWasteResult(tps, total,
                                  np.broadcast_to(faulty,
                                                  placed.shape).copy(),
                                  placed)


def _torch_kernel(model: ACOSModel, tps: Sequence[int]):
    """torch mirror of ``_batch_eval`` over a ``(rows, W)`` mask block
    (int32 on device, same contract as the builders in
    ``repro_torch.sim.torch_backend``)."""
    import torch

    from ..sim.torch_backend import _clip
    n_arrays, modeled = model._geometry()
    g = model.gpus_per_node
    array_gpus = model.array_nodes * g
    cap = model.uplink_nodes * g
    i32 = torch.int32

    def fn(masks):
        m = _clip(masks, model.num_nodes)
        arrays = m[:, :modeled].reshape(m.shape[0], n_arrays, model.array_nodes)
        f_nodes = arrays.sum(dim=2, dtype=i32)
        h_gpus = (model.array_nodes - f_nodes) * g
        total_healthy = h_gpus.sum(dim=1, dtype=i32)
        placed = []
        for tp in tps:
            tp = int(tp)
            if tp <= array_gpus:
                q = (h_gpus // tp) * tp
                pool = torch.clamp(h_gpus - q, max=cap).sum(dim=1, dtype=i32)
                placed.append(q.sum(dim=1, dtype=i32) + (pool // tp) * tp)
            else:
                placed.append((total_healthy // tp) * tp)
        placed = torch.stack(placed, dim=1)
        faulty = f_nodes.sum(dim=1, dtype=i32) * g
        return faulty[:, None].expand_as(placed), placed
    return fn


#: One 128-GPU (32-node) array: 2 OCS transceivers per node into the
#: cheap-switch bank, 8 small 32-port OCS units, one fiber pair per
#: transceiver -- the whole point is trading one big OCS for many cheap
#: small ones.
ACOS_BOM = ArchBOM("acos", gpus=128, per_gpu_bw_gbps=400.0, components=[
    Component("OCSTrx (400G)", 64, 600.0, 100.0, 12.0),
    Component("Small OCS (32-port)", 8, 4000.0, 0.0, 25.0),
    Component("Fiber", 64, 6.80, 100.0, 0.0),
])


register(ArchSpec(
    name="acos",
    factory=lambda n, g: ACOSModel(n, g),
    bom=ACOS_BOM,
    torch_kernel=_torch_kernel,
    placement_variant="dgx-island",
    default_sweep=False,
    paper="ACOS (arXiv 2602.17449)"))
