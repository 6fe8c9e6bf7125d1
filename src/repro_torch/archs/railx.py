"""RailX architecture (Feng et al., arXiv 2507.18889).

RailX is a reconfigurable low-cost rail network: nodes sit on fixed
intra-row rails and optical circuit switching at the *row edges* re-splices
rows into one datacenter-scale ring.  Compared to InfiniteHBD's K-hop
per-node OCS transceivers, the reconfiguration points are per *row*, not
per node -- cheaper optics, coarser fault isolation.

Waste model (documented extension; the retrieved abstract gives topology
intent, not algorithms): a row whose nodes are all healthy contributes its
full length to the global ring; a row with faults contributes only its
healthy *head* run (before the first fault) and *tail* run (after the last
fault), which the edge OCS splices onto the neighboring rows' runs.
Healthy segments strictly *between* two faults of a row are stranded --
they have no OCS exit.  The spliced global chain is then carved into
TP-sized groups like any ring:

    chain  = sum over rows of (head + tail | full row)
    placed = floor(chain / m) * m * gpus_per_node,   m = tp // gpus_per_node

Scalar reference, batched NumPy kernel and torch device kernel all implement
exactly this arithmetic, so the registry's bit-exactness gates apply
unchanged.  The BOM prices one 4-GPU node with per-node DAC rail links
plus a one-third share of its row-edge OCS transceivers (8 per node at
row length 64) -- $1313.40/GPU, pinned by ``tests/test_registry.py``.
"""

from __future__ import annotations

from typing import Sequence, Set

import numpy as np

from ..core.arch import ArchSpec, register
from ..core.cost_model import ArchBOM, Component
from ..core.hbd_models import BatchedWasteResult, HBDModel, WasteResult

ROW_NODES = 64


class RailXModel(HBDModel):
    """Row-based reconfigurable ring: edge runs splice, interior strands."""

    name = "railx"

    def __init__(self, num_nodes: int, gpus_per_node: int = 4,
                 row_nodes: int = ROW_NODES):
        super().__init__(num_nodes, gpus_per_node)
        self.row_nodes = row_nodes

    def _static_config(self):
        return (self.row_nodes,)

    def _geometry(self):
        n_rows = self.num_nodes // self.row_nodes
        return n_rows, n_rows * self.row_nodes

    def evaluate(self, faults: Set[int], tp_size: int) -> WasteResult:
        L = self.row_nodes
        g = self.gpus_per_node
        n_rows, modeled = self._geometry()
        m = max(1, tp_size // g)
        chain = 0
        for r in range(n_rows):
            lo = r * L
            row_faults = sorted(u - lo for u in faults if lo <= u < lo + L)
            if not row_faults:
                chain += L
            else:
                chain += row_faults[0] + (L - 1 - row_faults[-1])
        placed = (chain // m) * m * g
        faulty = self._faulty_gpus({u for u in faults if u < modeled})
        return WasteResult(modeled * g, faulty, placed)

    def _batch_eval(self, masks: np.ndarray,
                    tps: np.ndarray) -> BatchedWasteResult:
        L = self.row_nodes
        g = self.gpus_per_node
        n_rows, modeled = self._geometry()
        snaps = masks.shape[0]
        rows = masks[:, :modeled].reshape(snaps, n_rows, L)
        any_f = rows.any(axis=2)
        first = rows.argmax(axis=2)
        last = L - 1 - rows[:, :, ::-1].argmax(axis=2)
        head = np.where(any_f, first, L).astype(np.int64)
        tail = np.where(any_f, L - 1 - last, 0).astype(np.int64)
        chain = (head + tail).sum(axis=1)                     # (S,)
        faulty = rows.sum(axis=(1, 2), dtype=np.int64)[:, None] * g
        placed = np.zeros((snaps, len(tps)), dtype=np.int64)
        for ti, tp in enumerate(tps):
            m = max(1, int(tp) // g)
            placed[:, ti] = (chain // m) * m * g
        total = np.full(len(tps), modeled * g, dtype=np.int64)
        return BatchedWasteResult(tps, total,
                                  np.broadcast_to(faulty, placed.shape).copy(),
                                  placed)


def _torch_kernel(model: RailXModel, tps: Sequence[int]):
    """torch mirror of ``_batch_eval`` over a ``(rows, W)`` mask block
    (int32 on device, same contract as the builders in
    ``repro_torch.sim.torch_backend``)."""
    import torch

    from ..sim.torch_backend import _clip
    L = model.row_nodes
    g = model.gpus_per_node
    n_rows, modeled = model._geometry()
    ms = [max(1, int(tp) // g) for tp in tps]
    i32 = torch.int32

    def fn(masks):
        m = _clip(masks, model.num_nodes)
        rows = m[:, :modeled].reshape(m.shape[0], n_rows, L)
        any_f = rows.any(dim=2)
        r8 = rows.to(torch.uint8)
        first = torch.argmax(r8, dim=2).to(i32)     # first fault (first max)
        last = L - 1 - torch.argmax(r8.flip(2), dim=2).to(i32)
        head = torch.where(any_f, first, L)
        tail = torch.where(any_f, L - 1 - last, 0)
        chain = (head + tail).sum(dim=1, dtype=i32)
        faulty = rows.sum(dim=(1, 2), dtype=i32) * g
        placed = torch.stack([(chain // mm) * mm * g for mm in ms], dim=1)
        return faulty[:, None].expand_as(placed), placed
    return fn


#: One 4-GPU RailX node: 2 intra-row DAC rail links plus 8 row-edge
#: OCS transceiver shares (row of 64 nodes), Table-8 unit prices.
RAILX_BOM = ArchBOM("railx", gpus=4, per_gpu_bw_gbps=800.0, components=[
    Component("DAC cable (1.6T)", 2, 199.60, 200.0, 0.1),
    Component("OCSTrx", 8, 600.0, 100.0, 12.0),
    Component("Fiber", 8, 6.80, 100.0, 0.0),
])


register(ArchSpec(
    name="railx",
    factory=lambda n, g: RailXModel(n, g),
    bom=RAILX_BOM,
    torch_kernel=_torch_kernel,
    placement_variant="orchestrated",
    default_sweep=False,
    paper="RailX (arXiv 2507.18889)"))
