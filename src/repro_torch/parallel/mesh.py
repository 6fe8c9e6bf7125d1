"""Process meshes of the port: what ``repro/parallel/compat.py`` provides.

``compat.py`` resolves the spellings of JAX releases: ``shard_map``,
``axis_size``, ``make_mesh`` and ``make_auto_mesh``.  The port runs one
process per rank over ``torch.distributed`` (SPMD by processes), so what it
needs from there is a mesh over the world and each axis's size and this
rank's index on it:

* :func:`make_mesh` -- a ``DeviceMesh`` over the current world, ranks in
  row-major order (``make_mesh``);
* :func:`mesh_axis` -- the :class:`Axis` of one mesh dimension: its process
  group, its global ranks in the mesh's order and this rank's coordinate;
* :func:`axis_size`, :func:`axis_index` (``lax.axis_size``,
  ``lax.axis_index``);
* :func:`fake_world` -- a world of any size in this one process, over
  ``torch.distributed``'s ``"fake"`` backend: the production mesh of 256 or
  512 ranks is built over it for the dry run
  (:mod:`repro_torch.launch.dryrun`), which runs rank 0's step on ``meta``
  tensors and moves nothing.

``shard_map`` has no counterpart: every rank runs the model code on its own
shard, and the collectives of :mod:`repro_torch.parallel.collectives` move
data between shards.  ``make_auto_mesh`` has none either: axis types are a
GSPMD notion, and the port has no partitioner.

A mesh dimension's process group lists its ranks sorted
(``torch.distributed.new_group`` sorts them, and a dimension that spans the
world gets the default group), not in the mesh's order, which on the
orchestrated mesh is the order of the live OCSTrx ring.  So an
:class:`Axis` keeps the mesh's order itself, and the collectives address
their peers by it.

The backend of a world is the caller's choice (:func:`spawn_world` takes it
without a default).  Gloo sends host memory only: point-to-point sends of
CUDA tensors over gloo abort (``writev: Bad address`` on an H100), while
its all-reduce and all-to-all take CUDA tensors and copy them themselves.
So :meth:`Axis.stages` says, from the group's backend alone, whether a
point-to-point payload must pass through a pinned host buffer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def device_type(device) -> str:
    """The type of ``device`` ("cuda" or "cpu"); raises for "cuda" without
    a card, so that an entry point's default device fails loudly here."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev.type


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh dimension as this rank sees it: ``ranks`` are the global
    ranks along it in the mesh's order, ``index`` this rank's coordinate
    (``ranks[index]`` is this rank), ``group`` their process group (None
    only for a one-rank axis, on which every collective returns its
    input)."""

    name: str
    ranks: Tuple[int, ...]
    index: int
    group: Optional[Any] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def stages(self, t: torch.Tensor) -> bool:
        """Whether a point-to-point send of ``t`` goes through host memory:
        a CUDA tensor over gloo."""
        return t.is_cuda and self.backend == "gloo"


def make_mesh(shape: Sequence[int], names: Sequence[str], *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the current world, global ranks
    laid out row-major, with ``names`` as its dimension names."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = device_type(device)
    n = math.prod(shape)
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; the world "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(kind, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def mesh_axis(mesh, name: str) -> Axis:
    """The :class:`Axis` of ``mesh``'s dimension ``name`` through this rank."""
    dim = mesh.mesh_dim_names.index(name)
    coord = mesh.get_coordinate()
    line = mesh.mesh[tuple(coord[:dim]) + (slice(None),) + tuple(coord[dim + 1:])]
    ranks = tuple(int(r) for r in line.tolist())
    group = mesh.get_group(name) if len(ranks) > 1 else None
    return Axis(name, ranks, coord[dim], group)


def axis_size(mesh, name: str) -> int:
    """The length of ``mesh``'s dimension ``name`` (``lax.axis_size``)."""
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on ``mesh``'s dimension ``name``
    (``lax.axis_index``)."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


# ------------------------------------------------------------ worlds


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a world of ``world_size`` ranks
    that exists only as a ``"fake"`` process group: groups and meshes can
    be built over it, and no collective moves data.  The group is torn down
    on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    # importing the module registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn: Callable, rank: int, world: int, backend: str, tmp: str,
               timeout_s: float, args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world_size: int, *args, backend: str,
                timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes that form
    one ``torch.distributed`` world on ``backend``, initialised through a
    file store in a temporary directory (no TCP port to collide over).
    ``fn`` and ``args`` must pickle (``fn`` by its import path).  Returns
    the ranks' return values in rank order.  A rank that fails ends the
    world: the others are killed and the failure's traceback is raised;
    so is a world that outlives ``timeout_s``."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, tmp, timeout_s, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks ran past {timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = [open(e).read() for r in failed
                    if os.path.exists(e := os.path.join(tmp, f"rank{r}.err"))]
            raise RuntimeError(f"ranks {failed} of {world_size} failed (exit codes "
                               f"{[procs[r].exitcode for r in failed]}):\n" + "\n".join(errs))
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
