"""Hooks through which the port's lower layers report their work to a
running op-level analysis.

A kernel wrapper reports each call of its kernel (:func:`report_kernel`:
FLOPs, bytes, exponentials, the tensors it made), a wire primitive of
:mod:`repro_torch.parallel.collectives` each transfer
(:func:`report_collective`: kind, payload, group size), beside the logical
collective that issued it (:func:`issued_by`).  Inside a wrapper or a
primitive the analysis counts no op of its own (:func:`suspended`), so that
a kernel's plain version on the CPU or a send staged through host memory is
counted by its report and not twice.

The analysis is :class:`repro_torch.launch.op_analysis.OpAnalysis`; it
enters itself here (:func:`push`, :func:`pop`) while it runs.  With none
running every hook is a no-op, so the reports stay in the hot paths.  This
module imports nothing, as the rest of :mod:`repro_torch.obs`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterable, List, Optional

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

_ACTIVE: List[Any] = []
_ISSUER: List[str] = []


def push(analysis) -> None:
    _ACTIVE.append(analysis)


def pop(analysis) -> None:
    _ACTIVE.remove(analysis)


def active() -> Optional[Any]:
    """The innermost running analysis, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def issuer() -> Optional[str]:
    """The outermost logical collective now issuing transfers, or None."""
    return _ISSUER[0] if _ISSUER else None


@contextlib.contextmanager
def suspended():
    """No op of the block is counted (a kernel's plain version, a wire
    primitive's staging); its work is reported instead."""
    a = active()
    if a is None:
        yield
        return
    a.suspend_depth += 1
    try:
        yield
    finally:
        a.suspend_depth -= 1


@contextlib.contextmanager
def issued_by(name: str):
    """Label the collectives of the block with the logical collective that
    issues them; an outer label wins (a ring all-reduce's reduce-scatter
    phase is the all-reduce's)."""
    _ISSUER.append(name)
    try:
        yield
    finally:
        _ISSUER.pop()


def issues(name: str):
    """Decorator: the function's collectives are issued by ``name``."""
    def wrap(fn):
        def inner(*args, **kwargs):
            with issued_by(name):
                return fn(*args, **kwargs)
        inner.__name__, inner.__doc__ = fn.__name__, fn.__doc__
        return inner
    return wrap


def report_kernel(name: str, *, flops: float, nbytes: float, transcendentals: float,
                  outputs: Iterable = ()) -> None:
    """One call of hand-written kernel ``name`` with the work its formula
    gives; ``outputs`` are the tensors it made."""
    a = active()
    if a is not None:
        a.add_kernel(name, flops, nbytes, transcendentals, outputs)


def track(tensors: Iterable) -> None:
    """Count ``tensors``, made in a suspended region, towards the live
    bytes while they live (a kernel's scratch, as the card allocates it)."""
    a = active()
    if a is not None:
        a.track(tensors)


def report_collective(kind: str, out, group_size: int, outputs: Iterable = ()) -> None:
    """One wire primitive of ``kind`` whose output is ``out`` over
    ``group_size`` ranks; ``outputs`` are the tensors it made."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    a = active()
    if a is not None:
        a.add_collective(kind, out, group_size, outputs)
