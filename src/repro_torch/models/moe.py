"""Mixture-of-Experts MLP of the port, the counterpart of
``repro/models/moe.py``, with the paper's two execution modes:

* ``moe_impl="tp"`` (paper default, §2.3 key finding): every expert's FFN is
  sharded over the model axis exactly like a dense MLP.  Computation is
  perfectly balanced regardless of routing, and the only HBD traffic is the
  all-reduce of the expert outputs (``ar_impl``: ``"ring"`` is the
  neighbor-only ring of :mod:`repro_torch.parallel.collectives`, ``"psum"``
  ``dist.all_reduce``).
* ``moe_impl="ep"``: experts are partitioned over the model axis and tokens
  travel to their experts via all-to-all.  ``a2a_impl="binary"`` uses the
  Appendix-G Binary-Exchange algorithm over XOR partners (the re-wired
  +-2^k backup links); ``a2a_impl="xla"`` ``dist.all_to_all_single``.

With ``tp == 1`` both modes run the same local capacity path, as in
``repro``.  With ``tp > 1`` the call runs on every rank of the model axis
(the process group it is given) with the rank's expert shards; dispatch is
local to the rank's data shard (capacity is per shard), as ``repro``'s
``shard_map`` body.

Dispatch is capacity-based, as in ``repro``: float32 router logits,
softmax, the top-k experts of each token renormalised; a token's
rank within its expert is the cumulative sum of the one-hot assignments,
and assignments ranked past ``capacity`` are dropped.  The experts run as
batched matrix products over the (E, C, d) buffer.

Two places pin what PyTorch leaves open:

* ``torch.topk`` promises no order among equal values, where ``lax.top_k``
  takes the lower index first, so :func:`top_k` is a stable descending sort.
* The combine adds each token's k weighted rows in slot order.  ``index_add_``
  on CUDA adds them with atomics in any order, so a bf16 result could differ
  between runs, and between a layer's forward and its remat recompute.

The buffer gets one row past its end, a sink: a dropped assignment is
written there, and the combine reads its zeros there.  ``repro`` adds the
zeroed row at (E-1, C-1) and reads row (e, C-1) of its expert times zero,
which gives the same values.  With the sink each buffer row is written and
read at most once, so neither direction needs an accumulating scatter (on
CUDA a sort of the T·k indices) and each gradient row receives one value.

Gradients under ``tp > 1``: the tokens and the router weights enter the
sharded region through Megatron's *f* (:func:`~repro_torch.parallel.collectives.copy_to`),
because each rank's use of them yields a partial result -- in ``tp`` mode
the routing weights scale partial expert outputs, in ``ep`` mode each rank
routes its own slice of the tokens -- so their gradients are summed over
the axis.  The outputs leave through *g* (the all-reduce, identity
backward).

A shared expert (Llama-4) is split over ``ff`` on the model axis in both
modes (``param_pspecs``, as ``repro``'s specs split ``shared``).  In
``ep`` mode each rank applies its ``ff`` share to all t tokens and adds
that partial to the re-assembled (t, d) output before the one all-reduce,
which then sums the routed slices and the shared expert's partials, as
``tp`` mode's does.  ``repro``'s ``ep`` body adds the shared expert as if
it were replicated, on the rank's token slice only, so each row lacks
(tp - 1)/tp of it (ROADMAP.md § 3); the port computes the whole expert.

``ep`` mode keeps ``repro``'s token slicing: rank i dispatches tokens
[i t_loc, (i + 1) t_loc) with t_loc = t // tp, so the trailing t % tp
tokens get no routed expert (all of them when t < tp, as in a decode step
of fewer lanes a data shard than model ranks); the shared expert still
reaches every row.  ``t_loc = 0`` runs an empty dispatch through the
exchange.

With telemetry on (``repro_torch.obs``) each call counts its assignments
(``moe.assignments``) and the dropped ones (``moe.dropped_assignments``, a
sum held on the tensors' device, read once when the summary is taken, so
counting adds no host sync).  The routing, the scatter into the buffer,
the experts and the combine run in ``torch.profiler`` ranges
(``moe.route``, ``moe.scatter``, ``moe.experts``, ``moe.combine``), so a
profile of a step gives each its device time.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel.collectives import (all_to_all_baseline,
                                              binary_exchange_all_to_all, copy_to,
                                              psum, ring_all_reduce)
from repro_torch.parallel.mesh import Axis


class MoE(nn.Module):
    """The parameters of one MoE MLP, named as ``repro``'s ``moe`` subtree:
    ``router`` (d, E) float32, ``w_up`` and ``w_gate`` (E, d, f), ``w_down``
    (E, f, d) and, with shared experts, the dense MLP ``shared`` of width
    ``f * n_shared_experts`` (so ``named_parameters``, the optimizer and
    checkpoints see ``moe.shared.w_up``)."""

    def __init__(self, router: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 w_gate: Optional[torch.Tensor] = None,
                 shared: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.router = nn.Parameter(router)
        self.w_up = nn.Parameter(w_up)
        self.w_down = nn.Parameter(w_down)
        self.w_gate = nn.Parameter(w_gate) if w_gate is not None else None
        self.shared = (nn.ParameterDict({k: nn.Parameter(v) for k, v in shared.items()})
                       if shared is not None else None)


def _experts(gen: torch.Generator, shape, std: float, device, dtype) -> torch.Tensor:
    """(E, ...) normal weights drawn one expert at a time: a float32 draw of
    all of Llama-4 Maverick's 128 experts at once would take 21 GB beside
    the bf16 result."""
    w = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        w[i] = torch.randn(shape[1:], generator=gen, device=device).mul_(std)
    return w


def init_moe(gen: torch.Generator, cfg: ModelConfig, device, dtype=torch.bfloat16) -> Dict:
    """Random MoE weights with ``repro``'s shapes and scales (the router in
    float32), drawn from ``gen`` on ``device``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": torch.randn((d, e), generator=gen, device=device) * s_in,
         "w_up": _experts(gen, (e, d, f), s_in, device, dtype),
         "w_down": _experts(gen, (e, f, d), s_ff, device, dtype)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = _experts(gen, (e, d, f), s_in, device, dtype)
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, d, f * cfg.n_shared_experts, cfg.act, device, dtype)
    return p


def _act(h: torch.Tensor, g: Optional[torch.Tensor], act: str) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(g) * h
    if act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    return F.gelu(h, approximate="tanh")


def top_k(x: torch.Tensor, k: int):
    """The k largest entries along the last axis and their indices, equal
    entries in index order, as ``lax.top_k`` gives them."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x2d: torch.Tensor, router_w: torch.Tensor, e: int, k: int, capacity: int):
    """Route T tokens: returns (buffer (E, C, d), combine metadata)."""
    t, d = x2d.shape
    with record_function("moe.route"):
        logits = x2d.float() @ router_w                          # (T, E)
        probs = torch.softmax(logits, dim=-1)
        topw, topi = top_k(probs, k)                             # (T, k)
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

        flat_e = topi.reshape(-1)                                # (T*k,)
        one_hot = F.one_hot(flat_e, e).to(torch.int32)           # (T*k, E)
        # rank within expert, scanned along each expert's contiguous row:
        # torch's CUDA scan down the T*k rows of (T*k, E) runs a thread a column
        ranks = torch.cumsum(one_hot.t().contiguous(), dim=1, dtype=torch.int32).t()
        pos = ranks * one_hot
        flat_pos = pos.sum(-1) - 1                               # (T*k,)
        keep = flat_pos < capacity

    with record_function("moe.scatter"):
        # each token's row k times, repro's x2d[repeat(arange(T), k)]
        rows = x2d[:, None].expand(t, k, d).reshape(t * k, d)
        buf = x2d.new_zeros((e * capacity + 1, d)).index_put(
            (_slots(flat_e, flat_pos, keep, e, capacity),), rows)
    meta = (flat_e, flat_pos, keep, topw.reshape(-1), t, k)
    return buf[:-1].view(e, capacity, d), meta


def _slots(flat_e, flat_pos, keep, e: int, capacity: int) -> torch.Tensor:
    """Each assignment's row of the flattened (E*C + 1, d) buffer: expert
    e's rank r at e*C + r, a dropped one at the sink row E*C."""
    return torch.where(keep, flat_e * capacity + flat_pos, e * capacity)


def _combine(out_buf: torch.Tensor, meta, dtype) -> torch.Tensor:
    """Each token's k expert rows, weighted, summed in slot order."""
    flat_e, flat_pos, keep, w, t, k = meta
    e, capacity, d = out_buf.shape
    padded = torch.cat([out_buf.reshape(e * capacity, d), out_buf.new_zeros((1, d))])
    gathered = padded.index_select(0, _slots(flat_e, flat_pos, keep, e, capacity))
    gathered = gathered * (w * keep).to(out_buf.dtype)[:, None]
    rows = gathered.view(t, k, d)                                # (T, k, d)
    y = rows[:, 0]
    for j in range(1, rows.shape[1]):
        y = y + rows[:, j]
    return y.to(dtype)


def _count(t: int, k: int, keep: torch.Tensor) -> None:
    if obs.enabled():
        obs.count("moe.assignments", t * k)
        obs.count_held("moe.dropped_assignments", (~keep).sum())


def _expert_ffn(buf: torch.Tensor, w_up, w_gate, w_down, act: str) -> torch.Tensor:
    with record_function("moe.experts"):
        h = torch.bmm(buf, w_up)
        g = torch.bmm(buf, w_gate) if w_gate is not None else None
        return torch.bmm(_act(h, g, act), w_down)


def moe_apply_local(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                    moe_impl: str = "tp", a2a_impl: str = "binary",
                    ar_impl: str = "psum", tp: int = 1,
                    group: Optional[Axis] = None) -> torch.Tensor:
    """The MoE MLP on local tokens x (Bt, S, d) -> (Bt, S, d) in x's dtype,
    ``repro``'s ``moe_apply_local``.  The buffer is in x's dtype, the
    combine runs in the experts' output dtype.

    With ``tp > 1``, ``group`` is the model axis (``tp`` ranks) and x is
    replicated over it; the expert weights are this rank's shards:
      tp mode: w_up/w_gate (E, d, f/tp), w_down (E, f/tp, d)
      ep mode: w_up/w_gate (E/tp, d, f), w_down (E/tp, f, d)
    The output is replicated over the axis."""
    if moe_impl not in ("tp", "ep"):
        raise ValueError(f"moe_impl is 'tp' or 'ep', not {moe_impl!r}")
    if tp != 1 and (group is None or group.size != tp):
        got = "none" if group is None else f"one of {group.size} ranks"
        raise ValueError(f"moe_apply_local with tp={tp} runs on the model axis: it needs "
                         f"that axis's process group of {tp} ranks (group=), got {got}")
    bt, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    router = p.router
    if tp > 1:
        x2d, router = copy_to(x2d, group), copy_to(router, group)

    if moe_impl == "tp" or tp == 1:
        capacity = max(1, int(cfg.capacity_factor * t * k / e))
        buf, meta = _dispatch(x2d, router, e, k, capacity)
        _count(t, k, meta[2])
        out = _expert_ffn(buf, p.w_up, p.w_gate, p.w_down, cfg.act)   # partial over f/tp
        # combine while still partial: (T,d) is k*capacity_factor x smaller
        # than (E,C,d), so the all-reduce moves less -- and the shared
        # expert's partial folds into the same reduction for free.
        with record_function("moe.combine"):
            y = _combine(out, meta, x.dtype)
        if p.shared is not None:
            y = y + L.mlp_apply(p.shared, x2d, cfg.act)
        if tp > 1:
            y = ring_all_reduce(y, group, impl=ar_impl)
        return y.reshape(bt, s, d)

    # EP: experts live on other ranks; tokens travel.  The incoming tokens
    # are replicated over the model axis (the batch is data-sharded), so
    # each EP rank dispatches only its 1/tp slice -- otherwise every expert
    # would process the same token tp times.
    if a2a_impl not in ("binary", "xla"):
        raise ValueError(f"a2a_impl is 'binary' or 'xla', not {a2a_impl!r}")
    if e % tp or p.w_up.shape[0] != e // tp:
        raise ValueError(f"ep mode over {tp} ranks holds {e} // {tp} experts a rank, got "
                         f"{p.w_up.shape[0]} (shard the weights with moe_impl='ep')")
    e_loc, idx, t_loc = e // tp, group.index, t // tp
    x_loc = x2d[idx * t_loc:(idx + 1) * t_loc]
    capacity = max(1, int(cfg.capacity_factor * t_loc * k / e))
    buf, meta = _dispatch(x_loc, router, e, k, capacity)
    _count(t_loc, k, meta[2])
    a2a = binary_exchange_all_to_all if a2a_impl == "binary" else all_to_all_baseline
    # (E, C, d) -> (tp, e_loc, C, d): slab r goes to rank r
    recv = a2a(buf.reshape(tp, e_loc, capacity, d), group)   # from each source
    toks = recv.movedim(0, 1).reshape(e_loc, tp * capacity, d)
    out = _expert_ffn(toks, p.w_up, p.w_gate, p.w_down, cfg.act)
    back = out.reshape(e_loc, tp, capacity, d).movedim(1, 0).contiguous()
    out_buf = a2a(back, group).reshape(e, capacity, d)
    with record_function("moe.combine"):
        y_loc = _combine(out_buf, meta, x.dtype)                 # (t_loc, d)
    # re-assemble the replicated (t, d) output across EP ranks
    y = torch.cat([y_loc.new_zeros((idx * t_loc, d)), y_loc,
                   y_loc.new_zeros((t - (idx + 1) * t_loc, d))])
    if p.shared is not None:
        # this rank's ff share of the shared expert over all t tokens: the
        # psum below sums the shares as tp mode's all-reduce does
        y = y + L.mlp_apply(p.shared, x2d, cfg.act)
    return psum(y, group).reshape(bt, s, d)
