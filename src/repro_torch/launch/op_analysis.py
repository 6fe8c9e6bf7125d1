"""Op-level analysis of one step, the counterpart of
``repro/launch/hlo_analysis.py``.

``repro`` parses the optimized HLO of a compiled step.  The port runs the
step eagerly, so there is no HLO to parse: :class:`OpAnalysis` is a
``TorchDispatchMode`` that sees every aten op the step dispatches, on
``meta`` tensors (a dry run: shapes only, nothing computed) and on real
ones alike, and counts

  * dot FLOPs: every matmul-like op, by ``torch.utils.flop_counter``'s
    formulas, plus each hand-written kernel's formula (its wrapper reports
    it, :func:`repro_torch.obs.op_counts.report_kernel`);
  * traffic bytes: operand plus output bytes of every op that is not a
    view, plus each kernel's bytes.  Eager PyTorch materialises every op,
    so this is an upper bound for what a fused program would move;
  * transcendentals: output elements of exp, log, tanh, sigmoid, erf,
    rsqrt, sin and cos, plus each kernel formula's exponentials;
  * collectives: each wire primitive of
    :mod:`repro_torch.parallel.collectives` reports its kind (all-reduce,
    all-gather, reduce-scatter, all-to-all, collective-permute), its
    payload, dtype and group size, and the logical collective that issued
    it (:func:`~repro_torch.obs.op_counts.issued_by`: ring all-reduce, ring all-gather, binary
    exchange, ...).  Wire bytes use ``hlo_analysis``'s ring factors;
  * the peak of live tensor bytes: every storage an op creates is counted
    from its creation until it is freed; storages that exist before the
    analysis starts (the step's arguments) are not.

The port runs every layer in a Python loop, so its totals already count
each layer: they are what ``repro``'s loop-aware totals estimate.

Inside a kernel wrapper or a wire primitive the counting is suspended
(:func:`~repro_torch.obs.op_counts.suspended`): on the CPU a wrapper runs
the kernel's plain version, whose own ops would otherwise be counted
beside the kernel's formula, and over gloo a send of a CUDA tensor stages
it through host memory.  So a
``meta`` dry run, a CPU run and a CUDA run of one step count the same work.
The outputs of a suspended region are handed back (``outputs=``) so that
they count towards the peak.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, List

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..obs import op_counts

TRANSCENDENTAL = frozenset(("exp", "log", "tanh", "sigmoid", "erf", "rsqrt", "sin", "cos"))
# ops that pass a tensor through or make one without touching its bytes
# (names without a trailing underscore)
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "lift_fresh", "resize", "set",
                         "_local_scalar_dense", "detach", "alias", "_unsafe_view"))

def wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Bytes one rank puts on the wire for a collective of ``kind`` with
    ``out_bytes`` of output over ``n`` ranks: ``hlo_analysis``'s ring
    factors (all-reduce 2 (n - 1) / n, all-gather, reduce-scatter and
    all-to-all (n - 1) / n, a collective-permute one neighbour hop)."""
    if kind == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / max(n, 1)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return out_bytes * (n - 1) / max(n, 1)
    if kind == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _coll_entry() -> Dict[str, float]:
    return {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0, "wire_bytes_bf16": 0.0}


def _free_in(ref, key: int) -> None:
    """A tracked storage was freed: uncount it in its analysis, if that is
    still alive."""
    analysis = ref()
    if analysis is not None:
        analysis._free(key)


class OpAnalysis(TorchDispatchMode):
    """Counts what one step does (module docstring).  ``arguments`` are
    the step's inputs (parameters, optimizer state, batch): their storages
    are not counted towards the peak.  Use as a context manager around the
    step, then read :meth:`total_stats`, :meth:`cost`, :attr:`kernels` and
    :attr:`peak_bytes`."""

    def __init__(self, arguments: Iterable = ()):
        super().__init__()
        self.dot_flops = 0.0
        self.traffic_bytes = 0.0
        self.transcendentals = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: Dict[str, Dict[str, float]] = {}
        # (issuer, kind, group size) -> count and bytes
        self.issued: Dict[tuple, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.suspend_depth = 0
        self._sizes: Dict[int, int] = {}
        # the arguments' storages, held so that their ids stay theirs
        self._args = [t.untyped_storage() for t in _tensors(list(arguments))]
        self._arg_ids = {id(s) for s in self._args}

    # ------------------------------------------------------------ dispatch

    def __enter__(self):
        op_counts.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        op_counts.pop(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.suspend_depth:
            return out
        packet = func.overloadpacket
        if func.namespace not in ("aten", "prims"):
            return out                 # c10d ops are reported as collectives
        fn = flop_registry.get(packet)
        if fn is not None:
            self.dot_flops += fn(*args, **kwargs, out_val=out)
        name = packet.__name__.rstrip("_")
        outs = _tensors(out)
        if name in TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.traffic_bytes += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                                   + sum(_nbytes(t) for t in outs))
        self.track(outs)
        return out

    # ------------------------------------------------------------ memory

    def _free(self, key: int) -> None:
        self.live_bytes -= self._sizes.pop(key, 0)

    def track(self, tensors: Iterable) -> None:
        """Count the storages of the tensors among ``tensors`` that are new
        towards the live bytes until each is freed (a storage that grew is
        counted at its new size)."""
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._arg_ids:
                continue
            n = st.nbytes()
            old = self._sizes.get(key)
            if old is None:
                # through a weak reference: a storage made here that outlives
                # the step (a cached table, an output kept) must not keep the
                # analysis, and with it the arguments' storages, alive
                weakref.finalize(st, _free_in, weakref.ref(self), key)
                self._sizes[key] = n
                self.live_bytes += n
            elif old != n:
                self._sizes[key] = n
                self.live_bytes += n - old
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # ------------------------------------------------------------ reports

    def add_kernel(self, name: str, flops: float, nbytes: float, transcendentals: float,
                   outputs: Iterable[torch.Tensor]) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0,
                                           "transcendentals": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        k["transcendentals"] += transcendentals
        self.track(outputs)

    def add_collective(self, kind: str, out: torch.Tensor, n: int,
                       outputs: Iterable[torch.Tensor]) -> None:
        out_bytes = _nbytes(out)
        wire = wire_bytes(kind, out_bytes, n)
        d = self.collectives.setdefault(kind, _coll_entry())
        d["count"] += 1
        d["bytes"] += out_bytes
        d["wire_bytes"] += wire
        # as hlo_analysis: float32 payloads halved for the bf16-projected bytes
        d["wire_bytes_bf16"] += wire * (0.5 if out.dtype == torch.float32 else 1.0)
        key = (op_counts.issuer() or kind, kind, n)
        e = self.issued.setdefault(key, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
        e["count"] += 1
        e["bytes"] += out_bytes
        e["wire_bytes"] += wire
        self.track(outputs)

    # ------------------------------------------------------------ results

    def cost(self) -> Dict[str, float]:
        """``repro``'s ``cost_analysis`` keys: FLOPs, bytes accessed and
        transcendentals, the kernels' formulas included."""
        ks = self.kernels.values()
        return {"flops": self.dot_flops + sum(k["flops"] for k in ks),
                "bytes_accessed": self.traffic_bytes + sum(k["bytes"] for k in ks),
                "transcendentals": self.transcendentals + sum(k["transcendentals"] for k in ks)}

    def total_stats(self) -> Dict:
        """The keys of ``repro.launch.hlo_analysis.total_stats``: dot FLOPs
        (the kernels' included), traffic bytes, collective bytes and wire
        bytes in all and by kind."""
        cost = self.cost()
        coll = self.collectives.values()
        return {
            "dot_flops": cost["flops"],
            "traffic_bytes": cost["bytes_accessed"],
            "collective_bytes": sum(v["bytes"] for v in coll),
            "collective_wire_bytes": sum(v["wire_bytes"] for v in coll),
            "collective_wire_bytes_bf16": sum(v["wire_bytes_bf16"] for v in coll),
            "collectives": {k: {f: round(x, 1) for f, x in v.items()}
                            for k, v in sorted(self.collectives.items())},
        }

    def issued_stats(self) -> Dict[str, Dict]:
        """Collectives by the logical collective that issued them, then by
        kind and group size: ``{"ring all-gather": {"collective-permute@4":
        {count, bytes, wire_bytes}}}``."""
        out: Dict[str, Dict] = {}
        for (issuer, kind, n), v in sorted(self.issued.items()):
            out.setdefault(issuer, {})[f"{kind}@{n}"] = dict(v)
        return out

