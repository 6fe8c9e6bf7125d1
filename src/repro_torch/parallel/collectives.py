"""Ring + binary-exchange collectives over the HBD (model) axis, the
counterpart of ``repro/parallel/collectives.py`` on ``torch.distributed``.

The paper's design principle: the HBD only needs *neighbor* traffic, because
ring all-reduce is bandwidth-optimal [60].  These implementations make that
explicit -- every transfer of the ring is a point-to-point send to the
adjacent rank on the ring that the orchestrator laid over live OCSTrx links:

  * ``ring_all_reduce``    -- reduce-scatter + all-gather, 2(n-1) neighbor
                              steps, 2X(n-1)/n bytes on the wire per rank.
  * ``ring_reduce_scatter`` / ``ring_all_gather`` -- the two phases, usable
                              separately (ZeRO-1 wants RS fwd / AG on update).
  * ``binary_exchange_all_to_all`` -- Appendix G: node i talks to i XOR 2^k
                              in log2(n) rounds (the rewired ±2^k backup
                              links), O(p log p) vs the ring's O(p^2).

Every function takes the :class:`~repro_torch.parallel.mesh.Axis` of the
mesh dimension it runs over (``repro`` takes the axis name inside
``shard_map``) and addresses peers by their coordinates on it, in the
mesh's order.  On a one-rank axis each returns its input.  ``ppermute``
is one ``batch_isend_irecv``; a rank that no one sends to receives zeros,
as from ``lax.ppermute``.  ``impl="psum"`` is ``dist.all_reduce``, the
counterpart of the XLA collective, so tests can hold the ring to it.

The ring adds the chunks in ``repro``'s order, ``chunk + acc`` at each
step and ``acc + own chunk`` at the end, so a float32 result is bit-equal
to the JAX ring's.

Gradients (every rank runs the same program on its shard, so each
function's backward follows how its output is consumed, as Megatron's *f*
and *g* do):

  * :func:`copy_to` (*f*): identity forward, all-reduce of the gradient
    backward.  It marks a replicated value that enters a region where each
    rank uses it for a partial result (column-parallel projections, the
    vocab-parallel loss, a router whose output weights partial sums).
  * :func:`psum` and :func:`ring_all_reduce` (*g*): all-reduce forward,
    identity backward.  Their output is replicated and every rank computes
    the same loss from it; summing the gradients again would scale them by
    the axis size.
  * :func:`ring_reduce_scatter` and :func:`ring_all_gather` are each
    other's backward (each rank's output is its own term of the loss).
    They are Megatron's sequence-parallel pair around a tensor-parallel
    region: the all-gather enters it (each rank's use of the whole
    sequence yields a partial gradient, which the reduce-scatter sums
    into each rank's slice) and the reduce-scatter leaves it.
  * :func:`split_to` and :func:`gather_from` are the pair around a
    replicated region (one that every rank computes whole, as the MoE
    layer's output is): ``gather_from`` is an all-gather whose backward
    keeps this rank's slice of the (replicated) gradient, ``split_to``
    keeps this rank's slice and all-gathers the gradient backward.
  * The binary exchange and the all-to-all are their own inverses, so each
    one's backward is itself; ``ppermute``'s is the inverse permutation.
  * :func:`pmax` carries no gradient.

Gloo sends host memory only, so over a gloo group a CUDA payload of a
point-to-point send passes through pinned host buffers
(:meth:`~repro_torch.parallel.mesh.Axis.stages`); gloo's all-reduce and
all-to-all take CUDA tensors themselves.

Every transfer goes through one of three wire primitives: ``_exchange`` (a
point-to-point send and receive, reported as a collective-permute),
``_all_reduce`` and ``_all_to_all``.  Each reports its kind, payload and
group size to a running op-level analysis (:mod:`repro_torch.obs.op_counts`),
beside the logical collective that issued it (a ring all-gather, a binary
exchange, ...).  On ``meta`` tensors (the dry run,
:mod:`repro_torch.launch.dryrun`) they move nothing and return empty
tensors of the right shapes, so a step's collectives are counted without
a network.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..obs import op_counts as A
from .mesh import Axis


def _meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def _host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x)


def _exchange(x: torch.Tensor, group: Axis, dst: Optional[int],
              src: Optional[int]) -> torch.Tensor:
    """Send ``x`` to coordinate ``dst`` and receive a tensor like it from
    ``src`` (zeros where ``src`` is None)."""
    with A.suspended():
        if _meta(x):
            out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        else:
            out = _send_recv(x, group, dst, src)
    A.report_collective("collective-permute", out, group.size, (out,))
    return out


def _send_recv(x: torch.Tensor, group: Axis, dst: Optional[int],
               src: Optional[int]) -> torch.Tensor:
    stage = group.stages(x)
    buf = _host(x) if stage else x.contiguous()
    out = (torch.zeros(x.shape, dtype=x.dtype, pin_memory=True) if stage
           else torch.zeros_like(buf))
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, buf, group.ranks[dst], group.group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, group.ranks[src], group.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(x.device) if stage else out


def _ppermute(x: torch.Tensor, group: Axis, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    i = group.index
    dst = next((d for s, d in perm if s == i), None)
    src = next((s for s, d in perm if d == i), None)
    with A.issued_by("ppermute"):
        return _exchange(x, group, dst, src)


def _all_reduce(x: torch.Tensor, group: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    with A.suspended():
        out = x.detach().clone(memory_format=torch.contiguous_format)
        if not _meta(out):
            dist.all_reduce(out, op=op, group=group.group)
    A.report_collective("all-reduce", out, group.size, (out,))
    return out


def all_reduce_(t: torch.Tensor, group: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in place, outside autograd (the
    train step's data mean, gradient norm and optimizer statistics)."""
    if group.size == 1:
        return t
    with A.suspended():
        if not _meta(t):
            dist.all_reduce(t, op=op, group=group.group)
    A.report_collective("all-reduce", t, group.size)
    return t


@A.issues("ring reduce-scatter")
def _ring_rs(x: torch.Tensor, group: Axis, dim: int) -> torch.Tensor:
    n, i = group.size, group.index
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split into {n} chunks")
    chunks = x.split(x.shape[dim] // n, dim)
    acc = torch.zeros_like(chunks[0])
    for k in range(n - 1):
        # at step k rank i forwards the partial for chunk (i - k - 1):
        # adds its own copy and hands it to the +1 neighbor, receiving the
        # partial for chunk (i - k - 2) in exchange.
        send = chunks[(i - k - 1) % n] + acc
        acc = _exchange(send, group, (i + 1) % n, (i - 1) % n)
    # after n-1 steps rank i holds chunk i reduced over all other ranks
    return acc + chunks[i]


@A.issues("ring all-gather")
def _ring_ag(x: torch.Tensor, group: Axis, dim: int) -> torch.Tensor:
    n, i = group.size, group.index
    parts: List[Optional[torch.Tensor]] = [None] * n
    parts[i] = cur = x.contiguous()
    for k in range(n - 1):
        cur = _exchange(cur, group, (i + 1) % n, (i - 1) % n)
        parts[(i - k - 1) % n] = cur
    return torch.cat(parts, dim)


@A.issues("ring all-reduce")
def _ring_ar(x: torch.Tensor, group: Axis, chunk_axis: Optional[int]) -> torch.Tensor:
    n = group.size
    axis = chunk_axis
    if axis is None:
        # pick the first dim divisible by n (pad if none)
        axis = next((i for i, d in enumerate(x.shape) if d % n == 0), None)
    if axis is None:
        flat = x.reshape(-1)
        padded = torch.cat([flat, flat.new_zeros((-flat.shape[0]) % n)])
        red = _ring_ag(_ring_rs(padded, group, 0), group, 0)
        return red[: flat.shape[0]].reshape(x.shape)
    return _ring_ag(_ring_rs(x, group, axis), group, axis)


@A.issues("binary exchange")
def _binary_exchange(x: torch.Tensor, group: Axis) -> torch.Tensor:
    n, i = group.size, group.index
    rel = torch.tensor([r ^ i for r in range(n)], device=x.device)
    # re-index slabs by relative address: buf[r] = slab destined to (i XOR r)
    buf = x.index_select(0, rel)
    for k in range(n.bit_length() - 1):
        bit = 1 << k
        # the half whose relative address has bit k set goes to i XOR 2^k
        half = torch.tensor([r for r in range(n) if r & bit], device=x.device)
        recv = _exchange(buf.index_select(0, half), group, i ^ bit, i ^ bit)
        buf = buf.index_copy(0, half, recv)
    # buf[r] now holds the slab from rank (i XOR r) destined to us;
    # relabel to source-major order
    return buf.index_select(0, rel)


def _all_to_all(x: torch.Tensor, group: Axis) -> torch.Tensor:
    # all_to_all_single orders slabs by group rank (the sorted global
    # ranks); slab j belongs to mesh coordinate j
    order = [dist.get_group_rank(group.group, r) for r in group.ranks]
    at = torch.tensor(order, device=x.device)
    inp = torch.empty_like(x, memory_format=torch.contiguous_format).index_copy_(0, at, x)
    with A.suspended():
        out = torch.empty_like(inp)
        if not _meta(out):
            dist.all_to_all_single(out, inp, group=group.group)
    A.report_collective("all-to-all", out, group.size, (out,))
    return out.index_select(0, at)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, impl, chunk_axis):
        if impl == "psum":
            return _all_reduce(x, group)
        return _ring_ar(x, group, chunk_axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _ring_rs(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _ring_ag(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _ring_ag(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _ring_rs(g, ctx.group, ctx.dim), None, None


def _slice(x: torch.Tensor, group: Axis, dim: int) -> torch.Tensor:
    n = group.size
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split into {n} chunks")
    return x.chunk(n, dim)[group.index].contiguous()


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _ring_ag(g, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _ring_ag(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _SelfInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, fn):
        ctx.group, ctx.fn = group, fn
        return fn(x, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g, ctx.group), None, None


def ppermute(x: torch.Tensor, group: Axis, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: the (source, destination) pairs of ``perm`` name
    coordinates on ``group``; a rank without a source gets zeros."""
    if group.size == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, tuple(perm))


def copy_to(x: torch.Tensor, group: Axis) -> torch.Tensor:
    """Megatron's *f*: ``x`` unchanged; its gradient all-reduced over
    ``group``."""
    if group.size == 1:
        return x
    return _CopyTo.apply(x, group)


def psum(x: torch.Tensor, group: Axis) -> torch.Tensor:
    """``lax.psum`` as Megatron's *g*: the sum over ``group``; the gradient
    passes unchanged."""
    if group.size == 1:
        return x
    return _AllReduce.apply(x, group, "psum", None)


def pmax(x: torch.Tensor, group: Axis) -> torch.Tensor:
    """``lax.pmax`` of a value that carries no gradient."""
    if group.size == 1:
        return x.detach()
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def ring_reduce_scatter(x: torch.Tensor, group: Axis, scatter_axis: int = 0) -> torch.Tensor:
    """Ring reduce-scatter via n-1 neighbor sends.

    Input: the full array on every rank.  Output: rank i holds the fully
    reduced chunk i (along ``scatter_axis``).  Every step sends one chunk to
    the +1 neighbor -- on the orchestrated mesh this is a live OCSTrx link.
    """
    if group.size == 1:
        return x
    return _ReduceScatter.apply(x, group, scatter_axis)


def ring_all_gather(x: torch.Tensor, group: Axis, gather_axis: int = 0) -> torch.Tensor:
    """Ring all-gather via n-1 neighbor sends (chunks rotate around)."""
    if group.size == 1:
        return x
    return _AllGather.apply(x, group, gather_axis)


def split_to(x: torch.Tensor, group: Axis, axis: int = 0) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``axis`` (Megatron's scatter into
    the sequence-parallel region); the gradient is ring all-gathered."""
    if group.size == 1:
        return x
    return _SplitTo.apply(x, group, axis)


def gather_from(x: torch.Tensor, group: Axis, axis: int = 0) -> torch.Tensor:
    """The ring all-gather of every rank's chunk along ``axis``, whose
    gradient is this rank's chunk of the replicated gradient (the inverse
    of :func:`split_to`)."""
    if group.size == 1:
        return x
    return _GatherFrom.apply(x, group, axis)


def ring_all_reduce(x: torch.Tensor, group: Axis, impl: str = "ring",
                    chunk_axis: Optional[int] = None) -> torch.Tensor:
    """All-reduce; ``impl='ring'`` uses explicit neighbor-only sends
    (paper-faithful HBD traffic), ``impl='psum'`` ``dist.all_reduce``.
    Without a dimension that the axis divides, the ring runs on a padded
    flat copy."""
    if impl not in ("ring", "psum"):
        raise ValueError(f"impl is 'ring' or 'psum', not {impl!r}")
    if group.size == 1:
        return x
    return _AllReduce.apply(x, group, impl, chunk_axis)


def binary_exchange_all_to_all(x: torch.Tensor, group: Axis) -> torch.Tensor:
    """Appendix-G Binary Exchange all-to-all (XOR-Bruck).

    ``x`` has leading dim n: slab d on rank i is the data destined for rank
    d.  Slabs are re-indexed by the *relative* address r = dest XOR rank,
    which is invariant while a slab travels: in round k every rank sends to
    partner i XOR 2^k exactly the slabs whose r has bit k set (half the
    buffer, so n/2 slabs x log2(n) rounds = O(p log p) total traffic, vs the
    ring's O(p^2)).  A slab with relative address r is forwarded on every
    set bit of r and therefore ends on rank src XOR r == dest.  Each partner
    is a ±2^k neighbor -- exactly the rewired backup links of §7/Appendix G.

    Output layout matches ``all_to_all_baseline``: slab j = data from rank j.
    """
    n = group.size
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError("binary exchange needs a power-of-two axis")
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} is not the axis size {n}")
    return _SelfInverse.apply(x, group, _binary_exchange)


def all_to_all_baseline(x: torch.Tensor, group: Axis) -> torch.Tensor:
    """``dist.all_to_all_single`` over the leading slab dim (comparison
    point): slab j goes to coordinate j, and slab j of the result came from
    coordinate j."""
    if group.size == 1:
        return x
    if x.shape[0] != group.size:
        raise ValueError(f"leading dim {x.shape[0]} is not the axis size {group.size}")
    return _SelfInverse.apply(x, group, _all_to_all)
