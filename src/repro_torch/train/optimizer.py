"""Optimizers: AdamW and its memory-light variant (factored second moment,
bf16 first moment), with the arithmetic of ``repro/train/optimizer.py``.

The state is a dict: ``master``, ``m`` and ``v`` map each parameter's name
(``model.named_parameters()``) to its tensors, ``step`` is a Python int, so
the learning rate is known on the host without a device sync.  JAX builds
new trees; here every leaf is updated in place, one leaf at a time, so the
temporaries of a step are those of the largest leaf (the 151 M-entry
embedding of StarCoder2-3B: 0.6 GB in fp32) and never the whole model's.
A fused ``torch._foreach_*`` update over all 3 B parameters would need a
12 GB fp32 temporary per operation beside 48.5 GB of state.

Under a mesh each rank steps its own shards.  ``adamw_lowmem``'s factored
second moment averages the squared gradient over a parameter's last and
second-to-last dimensions, and ``denom`` averages ``vr`` over its last; where
mesh axes split such a dimension, the sums are all-reduced over them and
divided by the dimension's full length (``split`` of :func:`apply_updates`).
Like ``repro``, which factors by the stacked leaf's rank, the port factors
by each parameter's own rank (ROADMAP.md § 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.parallel.collectives import all_reduce_


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adamw_lowmem
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(model: nn.Module, cfg: OptConfig) -> Dict:
    """fp32 master weights and zero moments for every parameter."""
    if cfg.name not in ("adamw", "adamw_lowmem"):
        raise ValueError(cfg.name)
    master, m, v = {}, {}, {}
    for name, p in model.named_parameters():
        master[name] = p.detach().to(torch.float32, copy=True)
        if cfg.name == "adamw":
            m[name] = torch.zeros_like(p, dtype=torch.float32)
            v[name] = torch.zeros_like(p, dtype=torch.float32)
            continue
        # bf16 m and an Adafactor-style row/column-factored v
        m[name] = torch.zeros_like(p, dtype=torch.bfloat16)
        if p.dim() < 2:
            v[name] = {"v": torch.zeros_like(p, dtype=torch.float32)}
        else:
            v[name] = {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                       "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                         device=p.device)}
    return {"master": master, "m": m, "v": v, "step": 0}


def _lr_at(cfg: OptConfig, step: int) -> float:
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    return cfg.lr * warm


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32."""
    sq = sum(torch.sum(torch.square(t.float())) for t in tensors)
    return torch.sqrt(sq)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX computes its scalars."""
    return torch.tensor(x, dtype=torch.float32).item()


def _mean(t: torch.Tensor, dim: int, axes: Sequence, keepdim: bool = False) -> torch.Tensor:
    """The mean of ``t`` over ``dim``, whose entries are split over the mesh
    ``axes``: the local sum all-reduced over them over the full length."""
    if not axes:
        return torch.mean(t, dim=dim, keepdim=keepdim)
    total = torch.sum(t, dim=dim, keepdim=keepdim)
    n = t.shape[dim]
    for ax in axes:
        all_reduce_(total, ax)
        n *= ax.size
    return total.div_(n)


@torch.no_grad()
def apply_updates(model: nn.Module, opt_state: Dict, grads: Mapping[str, torch.Tensor],
                  cfg: OptConfig, grad_norm: Optional[torch.Tensor] = None,
                  split: Optional[Mapping[str, Tuple[Sequence, ...]]] = None
                  ) -> Dict[str, torch.Tensor]:
    """One optimizer step, in place on the model's parameters and on
    ``opt_state``; returns the metrics ``grad_norm`` and ``lr``.  Clipping
    uses ``grad_norm`` where given (a sharded model's global norm, which
    this rank's ``grads`` alone do not give), else the norm of ``grads``.
    ``split`` maps a parameter's name to the mesh axes (``Axis``) that split
    each of its dimensions; ``adamw_lowmem`` averages over them."""
    step = opt_state["step"]
    gn = global_norm(grads.values()) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = _f32(_lr_at(cfg, step))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = _f32(1.0 - _f32(b1) ** (step + 1))
    bc2 = _f32(1.0 - _f32(b2) ** (step + 1))
    for name, p in model.named_parameters():
        master, m = opt_state["master"][name], opt_state["m"][name]
        g = grads[name].to(torch.float32, copy=True).mul_(clip)
        if cfg.name == "adamw":
            v = opt_state["v"][name]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        else:
            vd = opt_state["v"][name]
            m32 = (b1 * m.float()).add_(g, alpha=1 - b1)
            g2 = g.mul_(g)
            if "v" in vd:
                vhat = vd["v"].mul_(b2).add_(g2, alpha=1 - b2) / bc2
            else:
                axes = (split or {}).get(name) or ((),) * p.dim()
                vr = vd["vr"].mul_(b2).add_(_mean(g2, -1, axes[-1]), alpha=1 - b2)
                vc = vd["vc"].mul_(b2).add_(_mean(g2, -2, axes[-2]), alpha=1 - b2)
                denom = torch.clamp(_mean(vr, -1, axes[-2], keepdim=True), min=1e-30)
                vhat = (vr[..., None] * vc[..., None, :]).div_(denom[..., None]).div_(bc2)
            u = (m32 / bc1).div_(vhat.sqrt_().add_(cfg.eps))
            m.copy_(m32)
        # master - lr * (u + wd * master), in place
        master.sub_(u.add_(master, alpha=cfg.weight_decay).mul_(lr))
        p.copy_(master)
    opt_state["step"] = step + 1
    return {"grad_norm": gn, "lr": lr}
