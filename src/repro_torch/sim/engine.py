"""Batched sweep runner: evaluate a ScenarioSpec grid in vectorized chunks.

Reproduces the paper's §6.2 fault-resiliency figures (Figs. 13-16: waste
ratio, max job scale, fault-waiting share) at grid scale; the churn
(Fig. 18), traffic (Fig. 17) and cost (§6.5) engines all consume the
grids it produces.

The counterpart of ``repro.sim.engine`` in the port.  The engine
materializes the snapshot fault-mask matrix once, then runs every
architecture's vectorized ``evaluate_batch`` kernel over it, chunking the
snapshot axis so datacenter-scale sweeps (100k nodes x thousands of
snapshots) stay within a bounded memory footprint.  Results land in a dense
``(architectures, snapshots, tp_sizes)`` grid that the table helpers reduce
to the paper's figures.

Two compute backends produce that grid bit-for-bit identically:

  * ``backend="numpy"`` -- the vectorized host kernels on each model;
  * ``backend="torch"`` -- ``repro_torch.sim.torch_backend``: the same
    kernels as torch functions batched over snapshot rows, on ``device``
    (``cuda`` by default; counter-stream masks are drawn on the device).

``backend="auto"`` (the default) picks torch whenever every requested
architecture has a torch kernel, on the ``device`` given: a ``cuda`` device
without a card raises, it never falls back to numpy or to the CPU.  The
``REPRO_SWEEP_BACKEND`` environment variable overrides the auto choice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.hbd_models import HBDModel
from ..core.prng import counter_fault_masks
from ..obs.progress import Progress, StreamProgress
from .scenario import CounterIIDSnapshots, ScenarioSpec

BACKENDS = ("numpy", "torch")


def resolve_backend(backend: Optional[str],
                    models: Sequence[HBDModel]) -> str:
    """Resolve ``backend`` ("auto"/None reads ``REPRO_SWEEP_BACKEND``).

    An explicit ``backend="torch"`` raises when a model has no torch
    kernel.  ``REPRO_SWEEP_BACKEND=torch`` falls back per call to numpy for
    models without a torch kernel, as ``auto`` does.  Which device the
    torch backend runs on is the caller's ``device`` argument, never
    chosen here.
    """
    if backend in (None, "auto"):
        backend = os.environ.get("REPRO_SWEEP_BACKEND", "auto").strip().lower() \
            or "auto"
        if backend not in ("auto",) + BACKENDS:
            raise ValueError(
                f"REPRO_SWEEP_BACKEND={backend!r} (want numpy|torch|auto)")
        if backend in ("auto", "torch"):
            from . import torch_backend
            return "torch" if torch_backend.available_for(models) else "numpy"
        return backend
    if backend == "torch":
        from . import torch_backend
        torch_backend.require(models)
        return "torch"
    if backend == "numpy":
        return "numpy"
    raise ValueError(f"unknown backend {backend!r} (numpy|torch|auto)")


@dataclasses.dataclass
class SweepResult:
    """Dense result grid of one scenario sweep.

    Grid axes are ``(architectures A, snapshots S, TP sizes T)`` for the
    per-snapshot counts; ``total_gpus`` is ``(A, T)`` because TP-granular
    models round the modeled cluster to whole groups.  ``backend`` records
    which compute path produced the grids -- they are bit-for-bit
    identical either way.
    """

    spec: ScenarioSpec
    names: List[str]         # architecture names, grid axis 0
    tp_sizes: np.ndarray     # (T,), grid axis 2
    total_gpus: np.ndarray   # (A, T)
    faulty_gpus: np.ndarray  # (A, S, T)
    placed_gpus: np.ndarray  # (A, S, T)
    backend: str = "numpy"   # compute backend that produced the grid

    @property
    def num_snapshots(self) -> int:
        return self.placed_gpus.shape[1]

    @property
    def healthy_gpus(self) -> np.ndarray:
        return self.total_gpus[:, None, :] - self.faulty_gpus

    @property
    def waste_ratio(self) -> np.ndarray:
        total = np.broadcast_to(self.total_gpus[:, None, :],
                                self.placed_gpus.shape)
        return np.divide(self.healthy_gpus - self.placed_gpus, total,
                         out=np.zeros(self.placed_gpus.shape),
                         where=total != 0)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def tp_index(self, tp: int) -> int:
        return int(np.nonzero(self.tp_sizes == tp)[0][0])


def evaluate_masks(models: Sequence[HBDModel], tp_sizes: Sequence[int],
                   masks: np.ndarray, *, chunk_snapshots: int = 1024,
                   backend: str = "auto",
                   device="cuda") -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, str]:
    """Evaluate a pre-materialized ``(snapshots, nodes)`` mask matrix.

    The mask-in/grids-out core shared by :func:`run_sweep` and the churn
    replay engine (``repro_torch.churn``): every model's batched kernel over every
    snapshot x TP cell, chunked along the snapshot axis.  Returns int64
    ``(total (A, T), faulty (A, S, T), placed (A, S, T), backend)`` grids,
    bit-for-bit identical across backends.  ``device`` is where the torch
    backend runs.
    """
    chosen = resolve_backend(backend, models)
    masks = np.asarray(masks, dtype=bool)
    tp_sizes = list(tp_sizes)

    with obs.span("sim.evaluate_masks", backend=chosen,
                  snapshots=masks.shape[0], models=len(models)):
        obs.count("sim.snapshots_evaluated", masks.shape[0])
        if chosen == "torch":
            from . import torch_backend
            total, faulty, placed = torch_backend.sweep_grids(
                models, tp_sizes, masks=masks,
                chunk_snapshots=chunk_snapshots, device=device)
            return total, faulty, placed, "torch"

        snaps = masks.shape[0]
        tcount = len(tp_sizes)
        total = np.zeros((len(models), tcount), dtype=np.int64)
        faulty = np.zeros((len(models), snaps, tcount), dtype=np.int64)
        placed = np.zeros((len(models), snaps, tcount), dtype=np.int64)
        chunk_snapshots = max(1, chunk_snapshots)  # same clamp as the torch path
        for lo in range(0, max(snaps, 1), chunk_snapshots):
            chunk = masks[lo:lo + chunk_snapshots]
            if not chunk.shape[0]:
                break
            with obs.span("sim.numpy.eval_chunk", rows=chunk.shape[0]):
                for ai, model in enumerate(models):
                    grid = model.evaluate_batch(chunk, tp_sizes)
                    total[ai] = grid.total_gpus
                    faulty[ai, lo:lo + chunk.shape[0]] = grid.faulty_gpus
                    placed[ai, lo:lo + chunk.shape[0]] = grid.placed_gpus
    return total, faulty, placed, "numpy"


def evaluate_mask_stream(models: Sequence[HBDModel], tp_sizes: Sequence[int],
                         chunks: Iterable[np.ndarray], total_snapshots: int,
                         *, chunk_snapshots: int = 1024,
                         backend: str = "auto",
                         progress: Optional[Callable[[Progress], None]] = None,
                         device="cuda"
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
    """Evaluate a *stream* of mask chunks in bounded memory.

    ``chunks`` is any iterable of ``(rows_i, nodes)`` bool matrices whose
    rows concatenate to ``total_snapshots`` snapshots.  Incoming chunks are
    re-chunked into ~``chunk_snapshots`` evaluation blocks (chunk
    boundaries in the source need not align with evaluation boundaries), so
    the grids are bit-for-bit equal to one :func:`evaluate_masks` call on
    the full concatenation while peak mask memory stays at about one block
    plus the largest single source chunk -- a million-snapshot x 10k-node
    stream never exists as a 10 GB host matrix.  On the torch backend each
    block goes to ``device`` through one pinned buffer
    (``repro_torch.sim.torch_backend.GridEvaluator``).

    ``progress`` is called once per evaluated block with a
    :class:`repro_torch.obs.Progress` (blocks done, snapshots/sec, ETA); the
    default publishes the same numbers as telemetry gauges under
    ``sim.stream.*`` -- a no-op unless telemetry is enabled -- so
    multi-minute streaming runs are never silent.
    """
    chosen = resolve_backend(backend, models)
    tp_sizes = list(tp_sizes)
    a_count, t_count = len(models), len(tp_sizes)
    total = np.zeros((a_count, t_count), dtype=np.int64)
    faulty = np.zeros((a_count, total_snapshots, t_count), dtype=np.int64)
    placed = np.zeros((a_count, total_snapshots, t_count), dtype=np.int64)
    chunk_snapshots = max(1, chunk_snapshots)
    state = {"lo": 0}
    pending: List[np.ndarray] = []
    pending_rows = 0
    tracker = StreamProgress(total_snapshots, progress, prefix="sim.stream")

    def flush() -> None:
        if not pending:
            return
        block = pending[0] if len(pending) == 1 else np.concatenate(pending)
        del pending[:]
        lo = state["lo"]
        with obs.span("sim.stream.block", rows=block.shape[0], offset=lo,
                      backend=chosen):
            t, f, p, _ = evaluate_masks(models, tp_sizes, block,
                                        chunk_snapshots=chunk_snapshots,
                                        backend=chosen, device=device)
        total[:] = t
        faulty[:, lo:lo + block.shape[0]] = f
        placed[:, lo:lo + block.shape[0]] = p
        state["lo"] = lo + block.shape[0]
        tracker.update(block.shape[0])

    with obs.span("sim.evaluate_mask_stream", backend=chosen,
                  snapshots=total_snapshots):
        for chunk in chunks:
            chunk = np.asarray(chunk, dtype=bool)
            if not chunk.shape[0]:
                continue
            pending.append(chunk)
            pending_rows += chunk.shape[0]
            if pending_rows >= chunk_snapshots:
                flush()
                pending_rows = 0
        flush()
    if state["lo"] != total_snapshots:
        raise ValueError(f"mask stream yielded {state['lo']} snapshots, "
                         f"expected {total_snapshots}")
    return total, faulty, placed, chosen


def run_sweep(spec: ScenarioSpec, *, masks: Optional[np.ndarray] = None,
              models: Optional[Sequence[HBDModel]] = None,
              chunk_snapshots: int = 1024,
              backend: str = "auto", device="cuda") -> SweepResult:
    """Evaluate the full scenario grid.

    ``masks``/``models`` may be supplied to reuse an already-materialized
    snapshot matrix or model instances (so timing can isolate the
    kernels).  ``backend`` selects the compute path and ``device`` where the
    torch backend runs (see the module docstring); the grids are
    bit-for-bit identical either way.
    """
    if models is None:
        models = spec.models()
    names = [m.name for m in models]
    tps = np.asarray(spec.tp_sizes, dtype=np.int64)
    chosen = resolve_backend(backend, models)

    with obs.span("sim.run_sweep", backend=chosen, nodes=spec.num_nodes,
                  models=len(models)):
        if chosen == "torch" and masks is None \
                and isinstance(spec.snapshots, CounterIIDSnapshots):
            from . import torch_backend
            # counter-based spec: draw the masks on the device (bit-
            # identical to the host mirror, no host matrix needed)
            gen = torch_backend.MaskGen(spec.snapshots.samples,
                                        spec.num_nodes,
                                        spec.snapshots.fault_ratio,
                                        spec.snapshots.seed)
            total, faulty, placed = torch_backend.sweep_grids(
                models, spec.tp_sizes, gen=gen,
                chunk_snapshots=chunk_snapshots, device=device)
            return SweepResult(spec, names, tps, total, faulty, placed,
                               backend="torch")

        if masks is None:
            if isinstance(spec.snapshots, CounterIIDSnapshots):
                # counter streams regenerate any row range bit-identically
                # from a start offset, so stream the masks chunk by chunk --
                # a million-snapshot spec never materializes the full host
                # matrix on either backend
                sn = spec.snapshots
                step = max(1, chunk_snapshots)
                chunks = (counter_fault_masks(spec.num_nodes, sn.fault_ratio,
                                              min(step, sn.samples - off),
                                              sn.seed, start=off)
                          for off in range(0, sn.samples, step))
                total, faulty, placed, chosen = evaluate_mask_stream(
                    models, spec.tp_sizes, chunks, sn.samples,
                    chunk_snapshots=chunk_snapshots, backend=chosen,
                    device=device)
                return SweepResult(spec, names, tps, total, faulty, placed,
                                   backend=chosen)
            masks = spec.snapshots.masks(spec.num_nodes)
        total, faulty, placed, chosen = evaluate_masks(
            models, spec.tp_sizes, masks, chunk_snapshots=chunk_snapshots,
            backend=chosen, device=device)
        return SweepResult(spec, names, tps, total, faulty, placed,
                           backend=chosen)


def run_sweep_scalar(spec: ScenarioSpec, *,
                     masks: Optional[np.ndarray] = None,
                     models: Optional[Sequence[HBDModel]] = None) -> SweepResult:
    """Reference implementation: loop the scalar ``evaluate`` path.

    Exists for equivalence testing (``tests/test_torch_sweep.py``).
    """
    if masks is None:
        masks = spec.snapshots.masks(spec.num_nodes)
    masks = np.asarray(masks, dtype=bool)
    if models is None:
        models = spec.models()
    snaps = masks.shape[0]
    tcount = len(spec.tp_sizes)
    total = np.zeros((len(models), tcount), dtype=np.int64)
    faulty = np.zeros((len(models), snaps, tcount), dtype=np.int64)
    placed = np.zeros((len(models), snaps, tcount), dtype=np.int64)
    for ai, model in enumerate(models):
        clipped = masks[:, :model.num_nodes]
        for si in range(snaps):
            faults = set(np.nonzero(clipped[si])[0].tolist())
            for ti, tp in enumerate(spec.tp_sizes):
                r = model.evaluate(faults, int(tp))
                total[ai, ti] = r.total_gpus
                faulty[ai, si, ti] = r.faulty_gpus
                placed[ai, si, ti] = r.placed_gpus
    return SweepResult(spec, [m.name for m in models],
                       np.asarray(spec.tp_sizes, dtype=np.int64),
                       total, faulty, placed)
