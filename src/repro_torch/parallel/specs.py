"""Specs for the port's parameters, caches and optimizer state, the
counterpart of ``repro/parallel/specs.py``.

Name-based trailing-dim rules: each known leaf name maps to a logical spec
for its trailing dims.  ``repro`` pads extra leading dims (its scan
stacking) with None; the port holds one tensor per layer, so its specs have
the tensors' own ranks.  A spec is a tuple of mesh-axis names (or tuples of
them, or None) per dimension, as :func:`repro_torch.parallel.sharding.resolve`
gives it; ``()`` replicates.

:func:`shard_tensor` is the counterpart of ``shardings_for`` plus
``device_put``: it cuts this rank's slice of a full tensor.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from .mesh import axis_index, axis_size
from .sharding import Spec, get_rules, resolve

# logical trailing-dim specs per leaf name.  The "fsdp" axis (-> data under
# mesh_axes({"fsdp": "data"}); DEFAULT_RULES leave it unmapped) fully shards
# weights + optimizer states across the cluster.
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # attention
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp"),
    "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",),
    # dense mlp (3D MoE expert weights align on trailing dims)
    "w_up": ("fsdp", "ff"), "w_gate": ("fsdp", "ff"), "w_down": ("ff", "fsdp"),
    # ssd
    "w_z": ("fsdp", "ff"), "w_x": ("fsdp", "ff"), "w_B": ("fsdp", None),
    "w_C": ("fsdp", None), "w_dt": ("fsdp", "heads"),
    "conv_x_w": (None, "ff"), "conv_x_b": ("ff",),
    "conv_B_w": (None, None), "conv_B_b": (None,),
    "conv_C_w": (None, None), "conv_C_b": (None,),
    "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
    "norm_scale": ("ff",), "out_proj": ("ff", "fsdp"),
    # rglru
    "w_r": ("fsdp", "ff"), "w_i": ("fsdp", "ff"), "b_r": ("ff",), "b_i": ("ff",),
    "lam": ("ff",), "conv_w": (None, "ff"), "conv_b": ("ff",),
    "w_out": ("ff", "fsdp"),
    # router & norms
    "router": ("fsdp", None), "scale": (None,), "bias": (None,),
}

_MOE_EP_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_up": ("experts_ep", None, None), "w_gate": ("experts_ep", None, None),
    "w_down": ("experts_ep", None, None),
}

_CACHE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("batch", "seq_cache", "kv_heads", None),
    "v": ("batch", "seq_cache", "kv_heads", None),
    "pos": ("batch", "seq_cache"),
    "xk": ("batch", None, "kv_heads", None),
    "xv": ("batch", None, "kv_heads", None),
    "state": ("batch", "heads", None, None),
    "conv_x": ("batch", None, "ff"),
    "conv_B": ("batch", None, None),
    "conv_C": ("batch", None, None),
    "conv": ("batch", None, "ff"),
    "h": ("batch", "ff"),
}


def _leaf_logical(path: Sequence[str], ndim: int, rules_table,
                  moe_impl: Optional[str]) -> Tuple[Optional[str], ...]:
    """The logical axes of the leaf at ``path`` (its name's parts), of rank
    ``ndim``; ``()`` replicates."""
    in_moe = False
    for k in path:
        if k == "moe":
            in_moe = True
        if k == "shared":   # the shared expert is a plain TP-sharded MLP
            in_moe = False
    name = path[-1]
    if name == "embed":
        return ("vocab", None)
    if name == "lm_head":
        return (None, "vocab")
    table = dict(rules_table)
    if in_moe and moe_impl == "ep":
        table.update(_MOE_EP_RULES)
    logical_tail = table.get(name)
    if logical_tail is None:
        return ()
    pad = ndim - len(logical_tail)
    if pad < 0:  # leaf smaller than rule (e.g. a scalar): replicate
        return ()
    return (None,) * pad + tuple(logical_tail)


def _leaf_spec(path: Sequence[str], ndim: int, rules_table, moe_impl: Optional[str]) -> Spec:
    """The spec of the leaf at ``path`` (its name's parts), of rank ``ndim``."""
    return resolve(_leaf_logical(path, ndim, rules_table, moe_impl)) or ()


def fsdp_dim(name: str, ndim: int, moe_impl: str = "tp") -> Optional[int]:
    """The dimension of the parameter ``name`` (as ``named_parameters``
    gives it, from any module down) that the installed rules' ``fsdp`` axis
    splits; None when it has no ``fsdp`` dimension or the rules leave
    ``fsdp`` unmapped."""
    rules = get_rules()
    if rules is None or rules.get("fsdp") is None:
        return None
    logical = _leaf_logical(name.split("."), ndim, _PARAM_RULES, moe_impl)
    return logical.index("fsdp") if "fsdp" in logical else None


def param_pspecs(model: torch.nn.Module, moe_impl: str = "tp") -> Dict[str, Spec]:
    """The spec of every parameter, by its name in ``named_parameters``."""
    return {name: _leaf_spec(name.split("."), p.dim(), _PARAM_RULES, moe_impl)
            for name, p in model.named_parameters()}


def cache_pspecs(cache: Sequence[Mapping[str, torch.Tensor]],
                 seq_sharded: bool = False) -> list:
    """Specs of a decode cache (one dict a layer, as ``init_cache`` gives).

    ``seq_sharded=True`` shards the KV cache's sequence dim over the rules'
    ``seq_shard`` axis (``data`` for long-context decode, ``model`` under
    ``kvdedup``), the layout that ``init_cache(..., seq_sharded=True)``
    gives each rank and ``decode_step(..., seq_sharded=True)`` merges
    across.  :func:`shard_cache` cuts a rank's shard of a full cache with
    them.
    """
    swap = "seq_shard" if seq_sharded else None
    table = {k: tuple(swap if a == "seq_cache" else a for a in v)
             for k, v in _CACHE_RULES.items()}
    return [{name: _leaf_spec((name,), t.dim(), table, None) for name, t in layer.items()}
            for layer in cache]


def shard_cache(cache: Sequence[Mapping[str, torch.Tensor]], specs: Sequence[Mapping],
                mesh) -> list:
    """This rank's shard of a full decode cache (one dict a layer) under
    ``specs`` (:func:`cache_pspecs`) on ``mesh``: views, cut by
    :func:`shard_tensor`."""
    return [{name: shard_tensor(t, spec[name], mesh) for name, t in layer.items()}
            for layer, spec in zip(cache, specs)]


def opt_pspecs(param_specs: Mapping[str, Spec], model: torch.nn.Module,
               opt_name: str = "adamw") -> Dict:
    """Specs of the optimizer state: master and m mirror the param specs
    (under rules that map ``fsdp``, split over the data axis too); for the
    low-memory optimizer the factored second moment drops the reduced dim;
    the step is replicated.  ``init_opt_state`` builds the state from the
    parameters' shards, so each leaf of it is the slice these specs give."""
    out = {"master": dict(param_specs), "m": dict(param_specs), "step": ()}
    if opt_name == "adamw":
        out["v"] = dict(param_specs)
        return out
    v = {}
    for name, p in model.named_parameters():
        s = param_specs[name]
        if p.dim() < 2:
            v[name] = {"v": s}
            continue
        full = (None,) * (p.dim() - len(s)) + tuple(s)
        v[name] = {"vr": full[:-1], "vc": full[:-2] + full[-1:]}
    out["v"] = v
    return out


def _names(ax) -> Tuple[str, ...]:
    return ax if isinstance(ax, tuple) else (ax,)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of the full tensor ``t`` under ``spec`` on
    ``mesh`` (a view).  A dimension split over several mesh axes is cut
    major-to-minor in the order the spec names them, as a ``NamedSharding``
    lays it out.  Raises if a split does not divide its dimension."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        parts, idx = 1, 0
        for n in _names(ax):
            size = axis_size(mesh, n)
            parts, idx = parts * size, idx * size + axis_index(mesh, n)
        if t.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split "
                             f"into {parts} shards over {ax}")
        step = t.shape[dim] // parts
        t = t.narrow(dim, idx * step, step)
    return t
