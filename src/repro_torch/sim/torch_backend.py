"""torch compute backend for the batched scenario engine.

The counterpart of ``repro.sim.jax_backend``.  Every HBD model's
``evaluate_batch`` kernel is re-expressed as a torch function over a block of
snapshot masks, ``(rows, W)`` bool -> ``(faulty, placed)``, each ``(rows, T)``
int32: batched over the snapshot rows, where the JAX package writes one
snapshot and maps it with ``jax.vmap``.  :class:`GridEvaluator` pushes block
after block through the (architectures x TP sizes) kernels, each block split
into equal slices of rows over the evaluator's devices, as ``repro``'s
``shard_map`` splits the snapshot axis over every JAX device.

Guarantees (held by ``tests/test_torch_sweep.py`` on the CPU and by
``chip_smoke.py`` on the card):

  * bit-for-bit equality with the NumPy engine -- kernels compute in int32
    on the device (all grid quantities fit comfortably) and are widened to
    the engine's int64 grids on the host;
  * results independent of chunking;
  * for :class:`~repro_torch.sim.scenario.CounterIIDSnapshots` specs, fault
    masks are drawn *on the device* (``repro_torch.core.prng.
    counter_masks_at``, one ``fold_in`` per snapshot index) and equal the
    NumPy mirror ``counter_fault_masks`` exactly, so the two backends agree
    although the torch path never builds a host mask matrix.

The InfiniteHBD kernel takes its prefix sums over the node axis with the
hand-written CUDA scan (``repro_torch.kernels.prefix_scan``) on the card;
the other kernels are plain torch.  The device is explicit and defaults to
``cuda``; a ``cuda`` device without a card raises, it never falls back to
the CPU.

``device`` is one device or a sequence of them (:func:`devices`): ``"cuda"``
without an index is every visible card, as ``repro`` takes every JAX
device; ``"cuda:0"`` or ``"cpu"`` is one; ``["cuda:0"] * 4`` is four slices
of one card, each run on a CUDA stream of its own, and ``["cpu"] * 8`` eight
slices run one after the other.  A block's rows are padded to a multiple of
the slice count as ``repro`` pads them (zero masks, or counter indices past
the block's last), cut into equal slices, evaluated on their devices, put
back in order and the pad rows dropped, so the grids do not depend on the
slice count either.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from .. import obs
from ..core.hbd_models import (BigSwitch, HBDModel, InfiniteHBDModel,
                               NVLModel, SiPRingModel, TPUv4Model)
from ..core.prng import counter_masks_at
from ..kernels.prefix_scan import prefix_scan

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class MaskGen:
    """Device-side counter-based mask generation request (no host matrix)."""

    samples: int
    num_nodes: int
    fault_ratio: float
    seed: int


# ---------------------------------------------------------------- kernels
# Each builder returns fn(masks: (rows, W) bool) -> (faulty (rows, T),
# placed (rows, T)) in int32, where W is the raw mask width; the kernel
# itself clips/pads to the model's node count exactly like
# HBDModel._clip_masks.

def _clip(masks: torch.Tensor, n: int) -> torch.Tensor:
    w = masks.shape[1]
    if w == n:
        return masks
    if w > n:
        return masks[:, :n]
    return torch.cat([masks, masks.new_zeros((masks.shape[0], n - w))], dim=1)


class _Const:
    """A constant index or size tensor of a kernel, made on the host once
    and copied to each device the kernel runs on once."""

    def __init__(self, array: np.ndarray):
        self.host = torch.from_numpy(np.ascontiguousarray(array))
        self.copies: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self.copies:
            copy = self.host.to(device)
            if copy.is_cuda:
                # slices on other streams of the card read this copy: it
                # must be complete before any of them is launched
                torch.cuda.current_stream(device).synchronize()
            self.copies[device] = copy
        return self.copies[device]


def _tps(tps: Sequence[int]) -> _Const:
    return _Const(np.asarray([int(t) for t in tps], dtype=np.int32))


def _bigswitch_kernel(model: BigSwitch, tps: Sequence[int]):
    n, g, total = model.num_nodes, model.gpus_per_node, model.total_gpus
    tps_c = _tps(tps)

    def fn(masks):
        m = _clip(masks, n)
        t = tps_c.on(m.device)
        faulty = m.sum(dim=1, dtype=_I32)[:, None] * g
        placed = ((total - faulty) // t) * t
        return faulty.expand_as(placed), placed
    return fn


def infinitehbd_scans(model: InfiniteHBDModel) -> int:
    """Prefix-scan launches of one InfiniteHBD kernel call on a block of at
    least one row and one node: the fault-mask scan, plus the component-id
    scan on a closed ring."""
    return 2 if model.closed_ring else 1


def _infinitehbd_kernel(model: InfiniteHBDModel, tps: Sequence[int]):
    n, g, k = model.num_nodes, model.gpus_per_node, model.k
    closed = model.closed_ring
    ms = [max(1, int(tp) // g) for tp in tps]

    def fn(masks):
        m = _clip(masks, n)
        pos = torch.arange(n, dtype=_I32, device=m.device)
        # cs[:, i] = faults in nodes 0..i (the JAX kernel's cs without its
        # leading zero column): the hand-written scan on the card
        cs = prefix_scan(m)
        # a gap of >= K consecutive faults splits the K-hop line; runk marks
        # every completion of such a run (the component boundaries)
        runk = torch.zeros_like(m)
        if n >= k:
            runk[:, k - 1] = cs[:, k - 1] == k
            runk[:, k:] = (cs[:, k:] - cs[:, :n - k]) == k
        healthy = ~m
        # healthy strictly before i: i - (faults before i); the healthy
        # prefix needs no scan of its own
        before = pos - cs + m.to(_I32)
        n_healthy = (n - cs[:, -1])[:, None]
        del cs
        # scan-only component sizing, as in the JAX kernel: the healthy
        # prefix at the component's start (forward cummax over boundary-
        # tagged prefixes) and end (reverse cummin) give each node's rank
        # and component size
        comp_start = torch.cummax(torch.where(runk, before, 0), dim=1).values
        comp_end = torch.cummin(
            torch.where(runk, before, n_healthy).flip(1), dim=1).values.flip(1)
        rank = before - comp_start
        size = comp_end - comp_start
        del before, comp_start, comp_end
        if closed:
            # wrap merge: first and last components join when the
            # wrap-around fault gap is shorter than K
            cid = prefix_scan(runk)
            h8 = healthy.to(torch.uint8)
            any_h = healthy.any(dim=1)
            first_h = torch.argmax(h8, dim=1, keepdim=True)
            last_h = n - 1 - torch.argmax(h8.flip(1), dim=1, keepdim=True)
            s_first = size.gather(1, first_h)[:, 0]
            s_last = size.gather(1, last_h)[:, 0]
            wrap_gap = (first_h + n - last_h - 1)[:, 0]
            merge = (any_h & (cid.gather(1, first_h) != cid.gather(1, last_h))[:, 0]
                     & (wrap_gap < k))
            del cid, h8
        placed = []
        for mm in ms:
            # node is placed iff its m-block completes within the component
            nodes = (healthy & (rank - rank % mm + mm <= size)).sum(dim=1, dtype=_I32)
            if closed:
                delta = (((s_first + s_last) // mm) * mm
                         - (s_first // mm) * mm - (s_last // mm) * mm)
                nodes = nodes + torch.where(merge, delta, 0)
            placed.append(nodes * g)
        placed = torch.stack(placed, dim=1)
        faulty = (n - n_healthy) * g
        return faulty.expand_as(placed), placed
    return fn


def _nvl_kernel(model: NVLModel, tps: Sequence[int]):
    g = model.gpus_per_node
    npn = model.hbd_gpus // g
    n_hbd = model.num_nodes // npn
    spares = int(round(model.hbd_gpus * model.spare_fraction))
    compute = model.hbd_gpus - spares
    tps_c = _tps(tps)

    def fn(masks):
        m = _clip(masks, model.num_nodes)
        t = tps_c.on(m.device)
        isle = m[:, :n_hbd * npn].reshape(m.shape[0], n_hbd, npn)
        f_gpus = isle.sum(dim=2, dtype=_I32) * g
        avail = torch.clamp(compute - torch.clamp(f_gpus - spares, min=0), min=0)
        placed = ((avail[:, :, None] // t) * t).sum(dim=1, dtype=_I32)
        return f_gpus.sum(dim=1, dtype=_I32)[:, None].expand_as(placed), placed
    return fn


def _tpuv4_kernel(model: TPUv4Model, tps: Sequence[int]):
    g = model.gpus_per_node
    npc = model.cube_gpus // g
    n_cubes = model.num_nodes // npc
    n = model.num_nodes
    blocks = {}
    for tp in tps:
        tp = int(tp)
        if tp <= model.cube_gpus and tp not in blocks:
            # static sub-block id grid; tail blocks may overrun into the
            # neighbor cube (same quirk as the NumPy path) -- clip at N
            bn = max(1, tp // g)
            starts = np.arange(0, npc, bn)
            ids = (np.arange(n_cubes)[:, None, None] * npc
                   + starts[None, :, None]
                   + np.arange(bn)[None, None, :])
            blocks[tp] = (_Const(np.minimum(ids, max(n - 1, 0))), _Const(ids < n))

    def fn(masks):
        m = _clip(masks, n)
        rows = m.shape[0]
        cube = m[:, :n_cubes * npc].reshape(rows, n_cubes, npc)
        faulty = cube.sum(dim=(1, 2), dtype=_I32) * g
        healthy_cubes = (~cube.any(dim=2)).sum(dim=1, dtype=_I32)
        placed = []
        for tp in tps:
            tp = int(tp)
            if tp <= model.cube_gpus:
                idx, in_range = (c.on(m.device) for c in blocks[tp])
                f = m[:, idx] & in_range
                placed.append((~f.any(dim=3)).sum(dim=(1, 2), dtype=_I32) * tp)
            else:
                placed.append((healthy_cubes * model.cube_gpus // tp) * tp)
        placed = torch.stack(placed, dim=1)
        return faulty[:, None].expand_as(placed), placed
    return fn


def _sipring_kernel(model: SiPRingModel, tps: Sequence[int]):
    g, n = model.gpus_per_node, model.num_nodes

    def fn(masks):
        m = _clip(masks, n)
        faulty, placed = [], []
        for tp in tps:
            tp = int(tp)
            npr = max(1, tp // g)
            n_rings = n // npr
            rings = m[:, :n_rings * npr].reshape(m.shape[0], n_rings, npr)
            placed.append((~rings.any(dim=2)).sum(dim=1, dtype=_I32) * tp)
            faulty.append(rings.sum(dim=(1, 2), dtype=_I32) * g)
        return torch.stack(faulty, dim=1), torch.stack(placed, dim=1)
    return fn


_KERNELS: Dict[Type[HBDModel], Callable] = {
    BigSwitch: _bigswitch_kernel,
    InfiniteHBDModel: _infinitehbd_kernel,
    NVLModel: _nvl_kernel,
    TPUv4Model: _tpuv4_kernel,
    SiPRingModel: _sipring_kernel,
}


def _builder_for(model: HBDModel) -> Optional[Callable]:
    """Kernel builder of one model: the type-keyed builtin table first,
    then the model's ``repro_torch.core.arch`` spec (external architectures
    ship their builder in ``ArchSpec.torch_kernel``)."""
    builder = _KERNELS.get(type(model))
    if builder is None:
        from ..core import arch
        spec = arch.find(model.name)
        builder = spec.torch_kernel if spec is not None else None
    return builder


def available_for(models: Sequence[HBDModel]) -> bool:
    """True when every model has a torch kernel."""
    return all(_builder_for(m) is not None for m in models)


def require(models: Sequence[HBDModel]) -> None:
    missing = [m.name for m in models if _builder_for(m) is None]
    if missing:
        raise RuntimeError(
            f"backend='torch' has no kernel for model(s) {missing}; "
            f"use backend='numpy' or register an ArchSpec.torch_kernel")


def _device(device) -> torch.device:
    """One device; ``cuda`` without a card raises rather than running
    anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend='torch' on {dev}: no CUDA device is available; pass "
            f"device='cpu' to run the torch kernels on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the torch backend runs on cpu or cuda, not {dev}")
    return dev


def devices(device="cuda") -> List[torch.device]:
    """The devices the snapshot axis is split over: every visible card for
    ``"cuda"`` without an index (``torch.cuda.device_count()``), one device
    for any other single device, and each entry of a sequence (repeats make
    several slices of one device)."""
    if isinstance(device, (str, torch.device)):
        dev = _device(device)
        if dev.type == "cuda" and dev.index is None:
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [dev]
    out = [_device(d) for d in device]
    if not out:
        raise ValueError("device is an empty sequence")
    return out


def num_devices(device="cuda") -> int:
    """How many slices the snapshot axis is split into on ``device``."""
    return len(devices(device))


def pad_rows(block: np.ndarray, n: int, counter: bool) -> np.ndarray:
    """``block`` padded on its tail to a multiple of ``n`` rows, as
    ``repro`` pads a sharded block: zero masks, or counter indices past the
    block's last."""
    rows = block.shape[0]
    pad = -rows % n
    if not pad:
        return block
    if counter:
        return np.concatenate([block, block[-1] + 1 + np.arange(pad, dtype=block.dtype)])
    return np.concatenate([block, np.zeros((pad,) + block.shape[1:], block.dtype)])


class Slices:
    """Runs one function on equal slices of a block's rows, a slice a
    device.  On a card each slice runs on a stream of its own, after the
    work already queued on the card's current stream, and its result comes
    back to pinned host memory without a wait; :meth:`run` waits for every
    slice at the end.  Whatever a slice stages or allocates is made on its
    own stream, and the pinned buffers are held until that stream is done."""

    def __init__(self, devs: Sequence[torch.device]):
        self.devices = list(devs)
        multi = len(self.devices) > 1
        self.streams = [torch.cuda.Stream(device=d) if multi and d.type == "cuda" else None
                        for d in self.devices]

    def run(self, fn: Callable, block: np.ndarray) -> List[List[np.ndarray]]:
        """``fn(host_slice, device, held) -> [device tensors]`` on each
        slice (``held`` keeps the slice's pinned staging buffers, see
        :func:`_stage`); returns the tensors of every slice on the host, in
        slice order."""
        n = len(self.devices)
        step = block.shape[0] // n
        pending = []
        for i, (dev, stream) in enumerate(zip(self.devices, self.streams)):
            part = block[i * step:(i + 1) * step]
            if dev.type == "cpu":
                pending.append((None, [t.numpy() for t in fn(part, dev, [])], None))
                continue
            stream = stream or torch.cuda.current_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                held = []
                outs = []
                for t in fn(part, dev, held):
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    outs.append(buf.copy_(t, non_blocking=True))
                done = torch.cuda.Event()
                done.record(stream)
            pending.append((done, outs, held))
        results = []
        for done, outs, _held in pending:
            if done is not None:
                done.synchronize()
                outs = [b.numpy() for b in outs]
            results.append(outs)
        return results


def _stage(part: np.ndarray, dev: torch.device, held: list) -> torch.Tensor:
    """A host slice on ``dev``: through a pinned buffer that ``held`` keeps
    until the slice's stream is done with it."""
    host = torch.from_numpy(np.ascontiguousarray(part))
    if dev.type == "cpu":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True).copy_(host)
    held.append(pinned)
    return pinned.to(dev, non_blocking=True)


# ------------------------------------------------------------- grid runner

def _zero_snapshot_totals(models: Sequence[HBDModel],
                          tps: Sequence[int]) -> np.ndarray:
    """Per-model ``total_gpus`` rows, from the NumPy kernels on an empty
    snapshot batch -- guaranteed identical to the NumPy engine's totals."""
    return np.stack([
        np.asarray(m.evaluate_batch(np.zeros((0, m.num_nodes), bool),
                                    tps).total_gpus, dtype=np.int64)
        for m in models])


class GridEvaluator:
    """Reusable device grid evaluator bound to one ``(models, tps, width)``.

    Holds the kernels, the slices and the zero-snapshot totals so a
    *streaming* caller can push block after block through them -- device
    memory stays at about one block's working set no matter how many
    snapshots flow through.  :func:`sweep_grids` is a loop over
    :meth:`eval_block`; ``repro_torch.sim.engine``'s ``evaluate_mask_stream``
    drives one evaluator across an entire mask stream.
    """

    def __init__(self, models: Sequence[HBDModel], tps: Sequence[int],
                 width: int, gen: Optional[MaskGen] = None, *,
                 device="cuda"):
        require(models)
        self.models = list(models)
        self.tps = [int(t) for t in tps]
        self.width = width
        self.gen = gen
        self.slices = Slices(devices(device))
        self.ndev = len(self.slices.devices)
        self.kernels = [_builder_for(m)(m, self.tps) for m in self.models]

    def totals(self) -> np.ndarray:
        """Per-model (A, T) ``total_gpus`` grid (NumPy-engine identical)."""
        return _zero_snapshot_totals(self.models, self.tps)

    def _slice(self, part: np.ndarray, dev: torch.device, held: list):
        """One slice's ``(rows, A, 2, T)`` int32 grid on ``dev``: its masks
        staged through a pinned buffer, or drawn there from counter
        indices."""
        if self.gen is not None:
            idx = _stage(np.asarray(part, dtype=np.int64), dev, held)
            masks = counter_masks_at(idx, self.gen.num_nodes, self.gen.fault_ratio,
                                     self.gen.seed)
        else:
            masks = _stage(np.asarray(part, dtype=bool), dev, held)
        return [torch.stack([torch.stack(kfn(masks), dim=1) for kfn in self.kernels],
                            dim=1)]

    def eval_block(self, block: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Evaluate one block; returns int64 ``(faulty, placed)``, each
        ``(A, rows, T)``.

        ``block`` is a ``(rows, width)`` bool mask matrix -- or, when the
        evaluator was built with ``gen``, a ``(rows,)`` integer vector of
        counter-stream snapshot indices.  Rows are padded on the tail to a
        multiple of the slice count and the pad rows discarded.
        """
        rows = block.shape[0]
        with obs.span("sim.torch.eval_block", rows=rows, devices=self.ndev) as sp:
            t0 = time.perf_counter()
            block = pad_rows(np.asarray(block), self.ndev, self.gen is not None)
            out = np.concatenate([o[0] for o in self.slices.run(self._slice, block)])
            out = out[:rows]                               # (rows, A, 2, T)
            elapsed = time.perf_counter() - t0
            if elapsed > 0:
                rate = rows / elapsed
                sp.set(snaps_per_sec=round(rate, 1))
                obs.gauge("sim.torch.snaps_per_sec", rate)
            return (out[:, :, 0].transpose(1, 0, 2).astype(np.int64),
                    out[:, :, 1].transpose(1, 0, 2).astype(np.int64))


def sweep_grids(models: Sequence[HBDModel], tps: Sequence[int], *,
                masks: Optional[np.ndarray] = None,
                gen: Optional[MaskGen] = None,
                chunk_snapshots: int = 1024,
                device="cuda") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate the grid on ``device``; returns int64 (total, faulty, placed).

    Exactly one of ``masks`` (host snapshot matrix) and ``gen``
    (device-side counter generation) must be provided.
    """
    if (masks is None) == (gen is None):
        raise ValueError("provide exactly one of masks= and gen=")
    if masks is not None:
        masks = np.asarray(masks, dtype=bool)
        snaps, width = masks.shape
    else:
        snaps, width = gen.samples, gen.num_nodes

    a_count, t_count = len(models), len(tps)
    total = np.zeros((a_count, t_count), dtype=np.int64)
    faulty = np.zeros((a_count, snaps, t_count), dtype=np.int64)
    placed = np.zeros((a_count, snaps, t_count), dtype=np.int64)
    ev = GridEvaluator(models, tps, width, gen=gen, device=device)
    if snaps == 0:  # NumPy engine's zero-snapshot grid keeps totals at zero
        return total, faulty, placed

    total[:] = ev.totals()
    chunk = max(1, chunk_snapshots)
    chunk = -(-chunk // ev.ndev) * ev.ndev     # multiple of the slice count
    for lo in range(0, snaps, chunk):
        hi = min(lo + chunk, snaps)
        block = (masks[lo:hi] if masks is not None
                 else np.arange(lo, hi, dtype=np.int64))
        f, p = ev.eval_block(block)
        faulty[:, lo:hi] = f
        placed[:, lo:hi] = p
    return total, faulty, placed


__all__ = [
    "GridEvaluator", "MaskGen", "Slices", "available_for", "devices",
    "infinitehbd_scans", "num_devices", "pad_rows", "require", "sweep_grids",
]
