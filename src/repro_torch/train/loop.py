"""Training step and loop, the counterpart of ``repro/train/loop.py``.

``make_train_step`` builds the step: forward (each attention layer through
the flash-attention kernels on the card), loss, backward, gradient
accumulation over microbatches in float32, optimizer update.  PyTorch runs
eagerly, so there is no ``jit``; the step updates the model and the
optimizer state in place and returns them with its metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, init_params, lm_loss
from repro_torch.train.optimizer import OptConfig, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1          # gradient-accumulation steps
    remat: bool = True


def loss_fn(model, batch: Dict[str, torch.Tensor], train_cfg: TrainConfig) -> torch.Tensor:
    """Mean next-token loss; a VLM's prefix rows carry no label and are
    dropped before the loss, as in ``repro``."""
    h = forward(model, batch, remat=train_cfg.remat)
    prefix = model.cfg.prefix_len
    if prefix and "patches" in batch:
        h = h[:, prefix:]
    return lm_loss(model, h, batch["labels"])


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
        metrics = apply_updates(model, state["opt"], grads, train_cfg.opt)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, train_cfg: TrainConfig, seed: int = 0, *,
                     device="cuda", dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random weights from ``seed`` on ``device`` and a fresh optimizer state."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    model = init_params(cfg, gen, device=device, dtype=dtype)
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
