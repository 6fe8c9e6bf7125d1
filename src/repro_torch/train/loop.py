"""Training step and loop, the counterpart of ``repro/train/loop.py``.

``make_train_step`` builds the step: forward (each attention layer through
the flash-attention kernels on the card), loss, backward, gradient
accumulation over microbatches in float32, optimizer update.  PyTorch runs
eagerly, so there is no ``jit``; the step updates the model and the
optimizer state in place and returns them with its metrics.

Under a mesh (``repro_torch.parallel.parallel_rules``) each rank steps its
own shards on its data shard.  GSPMD gives ``repro`` the global mean's
gradients for free; here the step all-reduces every gradient over the
batch's axes (``data``, and ``pod``) and divides by their size, which is
the global mean since the shards are equal.  Under FSDP a weight split
over a batch axis gets its sum over that axis from its gather's backward,
so it is only divided there, and the optimizer steps the shards
(``adamw_lowmem`` reduces its factored statistics over the axes that
split each dimension).  Parameters replicated over ``model`` already hold
equal gradients there (the model code's *f* operators sum them), so
nothing is reduced over ``model``.  Clipping uses the global norm: the
squares of each parameter are summed over the mesh axes that split it, so
every entry counts once.  The loss metric is the mean over the batch's
axes.  Every reduction goes through
:func:`repro_torch.parallel.collectives.all_reduce_`, so the dry run
counts it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, init_params, lm_loss
from repro_torch.parallel.collectives import all_reduce_
from repro_torch.parallel.mesh import axis_size, mesh_axis
from repro_torch.parallel.sharding import get_mesh, get_rules
from repro_torch.parallel.specs import _names, param_pspecs
from repro_torch.train.optimizer import OptConfig, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1          # gradient-accumulation steps
    remat: bool = True
    moe_impl: str = "tp"           # paper default: TP-sharded experts
    a2a_impl: str = "binary"
    ar_impl: str = "psum"          # "ring" = explicit neighbor-only ring all-reduce


def loss_fn(model, batch: Dict[str, torch.Tensor], train_cfg: TrainConfig) -> torch.Tensor:
    """Mean next-token loss; a VLM's prefix rows carry no label, and
    ``lm_loss`` scores only the last ``labels.shape[1]`` rows, which drops
    them as ``repro`` does (also from a sequence-parallel slice)."""
    moe_ctx = {"moe_impl": train_cfg.moe_impl, "a2a_impl": train_cfg.a2a_impl,
               "ar_impl": train_cfg.ar_impl}
    h = forward(model, batch, moe_ctx=moe_ctx, remat=train_cfg.remat)
    return lm_loss(model, h, batch["labels"])


def _mesh_axes(logical: str):
    """The installed mesh's axes (size > 1) that ``logical`` maps to."""
    mesh, rules = get_mesh(), get_rules()
    if mesh is None or rules is None or rules.get(logical) is None:
        return []
    names = rules[logical] if isinstance(rules[logical], tuple) else (rules[logical],)
    return [ax for ax in (mesh_axis(mesh, n) for n in names) if ax.size > 1]


def _data_mean(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` averaged over the batch's mesh axes, in place."""
    n = 1
    for ax in axes:
        all_reduce_(t, ax)
        n *= ax.size
    return t.div_(n)


def _split_over(spec) -> set:
    """The mesh axes that a parameter's spec splits it over."""
    return {a for ax in spec if ax is not None
            for a in (ax if isinstance(ax, tuple) else (ax,))}


def _global_norm(grads: Dict[str, torch.Tensor], specs):
    """The norm of the whole model's gradient from this rank's shards: the
    squares of the leaves split over the same mesh axes are summed over
    those axes, so each entry counts once."""
    mesh = get_mesh()
    sums: Dict[tuple, torch.Tensor] = {}
    for name, g in grads.items():
        key = tuple(sorted(n for n in _split_over(specs[name]) if axis_size(mesh, n) > 1))
        if key not in sums:
            sums[key] = torch.zeros((), dtype=torch.float32, device=g.device)
        sums[key].add_(torch.sum(torch.square(g.float())))
    total = None
    for key in sorted(sums):
        for n in key:
            all_reduce_(sums[key], mesh_axis(mesh, n))
        total = sums[key] if total is None else total + sums[key]
    return torch.sqrt(total)


def sync_gradients(model, loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                   train_cfg: TrainConfig):
    """Under a mesh, this rank's ``grads`` averaged in place over the
    batch's axes, and ``(loss averaged over them, the whole model's
    gradient norm)``; off a mesh ``(loss, None)``.  A leaf that FSDP splits
    over a batch axis already holds the sum over that axis (its gather's
    backward reduce-scattered it), so it is only divided there."""
    if get_mesh() is None:
        return loss, None
    data_axes = _mesh_axes("batch")
    specs = param_pspecs(model, train_cfg.moe_impl)
    n = math.prod(ax.size for ax in data_axes)
    for name, g in grads.items():
        split = _split_over(specs[name])
        for ax in data_axes:
            if ax.name not in split:
                all_reduce_(g, ax)
        g.div_(n)
    loss = _data_mean(loss.clone(), data_axes)
    return loss, _global_norm(grads, specs)


def split_axes(model, moe_impl: str = "tp") -> Optional[Dict[str, tuple]]:
    """Under a mesh, each parameter's mesh axes (size > 1) by dimension, as
    its spec splits it (``apply_updates``' ``split``); None off a mesh."""
    mesh = get_mesh()
    if mesh is None:
        return None
    out = {}
    for name, spec in param_pspecs(model, moe_impl).items():
        p = model.get_parameter(name)
        full = (None,) * (p.dim() - len(spec)) + tuple(spec)
        out[name] = tuple(tuple(ax for ax in (mesh_axis(mesh, a) for a in _names(s) if s)
                                if ax.size > 1) for s in full)
    return out


def make_train_step(cfg: ModelConfig, train_cfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)`` with the
    metrics ``loss``, ``grad_norm`` and ``lr``."""

    def grads_of(model, batch):
        names, params = zip(*model.named_parameters())
        loss = loss_fn(model, batch, train_cfg)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        model = state["params"]
        mb = train_cfg.microbatches
        if mb > 1:
            # JAX sums the microbatches' grads into float32 zeros; so do we,
            # rather than letting autograd add them up in the weights' dtype
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in model.named_parameters()}
            loss = 0.0
            for part in zip(*(t.chunk(mb, dim=0) for t in batch.values())):
                l_mb, g_mb = grads_of(model, dict(zip(batch, part)))
                loss = loss + l_mb
                for n, g in g_mb.items():
                    acc[n].add_(g)
                del g_mb
            loss = loss / mb
            grads = {n: a.div_(mb) for n, a in acc.items()}
        else:
            loss, grads = grads_of(model, batch)
        loss, norm = sync_gradients(model, loss, grads, train_cfg)
        split = split_axes(model, train_cfg.moe_impl) if train_cfg.opt.name != "adamw" else None
        metrics = apply_updates(model, state["opt"], grads, train_cfg.opt, grad_norm=norm,
                                split=split)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, train_cfg: TrainConfig, seed: int = 0, *,
                     tp: int = 1, device="cuda", dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random weights from ``seed`` on ``device`` (heads padded for ``tp``)
    and a fresh optimizer state."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    model = init_params(cfg, gen, tp=tp, device=device, dtype=dtype)
    return {"params": model, "opt": init_opt_state(model, train_cfg.opt)}


def train_loop(cfg: ModelConfig, train_cfg: TrainConfig, data_iter, steps: int, *,
               state=None, seed: int = 0, device="cuda", log_every: int = 10,
               checkpoint_cb: Optional[Callable] = None, checkpoint_every: int = 0,
               step_time_cb: Optional[Callable] = None):
    """Simple synchronous loop used by the CLI and the tests."""
    if state is None:
        state = init_train_state(cfg, train_cfg, seed, device=device)
    step_fn = make_train_step(cfg, train_cfg)
    history = []
    for step in range(steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if step_time_cb:
            step_time_cb(step, dt)
        history.append(metrics)
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.1f}ms")
        if checkpoint_cb and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            checkpoint_cb(state, step)
    return state, history
