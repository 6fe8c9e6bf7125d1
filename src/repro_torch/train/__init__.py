"""Training runtime of the port: optimizer, synthetic data, train step and
loop, checkpoints.  ``repro.train.elastic`` needs meshes and comes with the
parallel slice."""

from .data import data_iter, synthetic_batch
from .loop import TrainConfig, init_train_state, loss_fn, make_train_step, train_loop
from .optimizer import OptConfig, apply_updates, global_norm, init_opt_state

__all__ = ["OptConfig", "TrainConfig", "apply_updates", "data_iter", "global_norm",
           "init_opt_state", "init_train_state", "loss_fn", "make_train_step",
           "synthetic_batch", "train_loop"]
