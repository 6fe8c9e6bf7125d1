"""Training runtime of the port: optimizer, synthetic data, train step and
loop, checkpoints, and the elastic runtime (``elastic``: fault-driven
re-planning of the mesh with checkpoint restore)."""

from .data import data_iter, synthetic_batch
from .loop import (TrainConfig, init_train_state, loss_fn, make_train_step, sync_gradients,
                   train_loop)
from .optimizer import OptConfig, apply_updates, global_norm, init_opt_state

__all__ = ["OptConfig", "TrainConfig", "apply_updates", "data_iter", "global_norm",
           "init_opt_state", "init_train_state", "loss_fn", "make_train_step",
           "sync_gradients", "synthetic_batch", "train_loop"]
