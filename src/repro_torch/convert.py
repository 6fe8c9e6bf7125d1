"""Build the port's model from the JAX package's parameter pytree.

``params_from_jax(cfg, tree)`` takes the pytree that ``repro``'s
``init_params`` returns, with every leaf already a numpy array (the caller
runs ``jax.tree.map(np.asarray, params)``), and returns the equivalent
:class:`~repro_torch.models.Transformer`.  The JAX tree stacks full pattern
groups: ``groups[s][name]`` has a leading ``n_groups`` axis, and layer
``g * cycle + s`` is its ``g``-th entry, where a cycle is the least common
multiple of the pattern's length and ``moe_every`` (Llama-4 Maverick's is 4,
GPT-MoE's 2); ``rest`` holds the remainder layers unstacked.  Subtrees nest
one level where ``repro``'s do: an MoE layer's ``moe`` holds its ``shared``
expert MLP, and a decoder layer of an encoder-decoder config its cross-attention
``normx`` and ``xattn``.  The encoder, ``tree["enc"]``, stacks all its layers
(``enc["layers"][name]`` has a leading ``enc_layers`` axis) beside its
``final_norm``; the port holds one entry a layer.  A JAX gradient tree has
the params' structure, so the
same function maps ``jax.grad``'s output onto the port's parameter names.
The parameters it makes are trainable, like ``init_params``'s.  A tree
that ``repro`` made with ``init_params(cfg, key, tp=...)`` carries its
padded heads over as they are, and one made with ``kv_pad=False`` its
unpadded KV heads (the ``kvdedup`` layout).

``shard_params(model, mesh, moe_impl)`` cuts a rank's shards of a full
model (the counterpart of ``device_put`` with ``param_pspecs``'
shardings).  This module imports neither JAX nor ``repro``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Encoder, Layer, Transformer, _check_layer

_SUBTREES = ("norm1", "attn", "ssd", "rglru", "normx", "xattn", "norm2", "mlp", "moe")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # the model owns its weights
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(fn, tree: Mapping[str, Any]) -> Dict[str, Any]:
    """``fn`` on every array of a nested dict."""
    return {k: _map(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def _layer(kind: str, i: int, p: Mapping[str, Any], device) -> Layer:
    _check_layer(kind)
    extra = set(p) - set(_SUBTREES)
    if extra:
        raise NotImplementedError(f"layer {i} holds unported parts {sorted(extra)}")
    return Layer(kind, **_map(lambda v: _tensor(v, device), p))


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any], *,
                    device="cuda") -> Transformer:
    """The port's model holding the weights of ``tree`` on ``device``."""
    groups = tree["groups"]
    cycle = len(groups)
    n_groups = (len(next(iter(groups[0]["norm1"].values()))) if cycle else 0)
    layers: Dict[int, Layer] = {}
    for s, slot in enumerate(groups):
        for g in range(n_groups):
            i = g * cycle + s
            layers[i] = _layer(cfg.pattern_at(i), i, _map(lambda v: v[g], slot), device)
    for j, p in enumerate(tree["rest"]):
        i = n_groups * cycle + j
        layers[i] = _layer(cfg.pattern_at(i), i, p, device)
    if sorted(layers) != list(range(cfg.num_layers)):
        raise ValueError(f"tree holds layers {sorted(layers)}, config wants "
                         f"{cfg.num_layers}")
    lm_head = tree.get("lm_head")
    enc = None
    if "enc" in tree:
        stacked = tree["enc"]["layers"]
        enc = Encoder([_layer("enc", i, _map(lambda v: v[i], stacked), device)
                       for i in range(cfg.enc_layers)],
                      _map(lambda v: _tensor(v, device), tree["enc"]["final_norm"]))
    return Transformer(
        cfg, _tensor(tree["embed"], device), [layers[i] for i in sorted(layers)],
        {k: _tensor(v, device) for k, v in tree["final_norm"].items()},
        _tensor(lm_head, device) if lm_head is not None else None, enc)


def shard_params(model: Transformer, mesh, moe_impl: str = "tp") -> Transformer:
    """A copy of ``model`` that holds this rank's slice of every parameter
    under ``param_pspecs(model, moe_impl)`` on ``mesh``, resolved by the
    installed rules (``repro_torch.parallel.parallel_rules``).  The slices
    are copies: the full model may be freed."""
    from repro_torch.parallel.specs import param_pspecs, shard_tensor

    specs = param_pspecs(model, moe_impl)
    memo = {id(p): torch.nn.Parameter(shard_tensor(p.detach(), specs[name], mesh).clone(),
                                      requires_grad=p.requires_grad)
            for name, p in model.named_parameters()}
    return copy.deepcopy(model, memo)
