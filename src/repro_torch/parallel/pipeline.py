"""Pipeline parallelism over the pod axis (beyond-paper feature), the
counterpart of ``repro/parallel/pipeline.py``.

GPipe-style schedule: layers are split into ``pp`` contiguous stages, one a
rank of the pod axis, and microbatches stream through them; the stage
handoff is a single ``ppermute`` (neighbor traffic on the DCN -- exactly
where the paper's orchestrator wants it, since aligned ranks sit under one
ToR).

This utility pipelines any per-stage function ``stage_fn(stage_idx, x)``;
the trainer wires model stages in when ``pp > 1`` is configured.
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import ppermute, psum
from .mesh import Axis


def gpipe(stage_fn: Callable, x_mb: torch.Tensor, *, group: Axis,
          n_micro: int) -> torch.Tensor:
    """Run microbatches through pipeline stages laid on the axis ``group``.

    x_mb: (n_micro, mb, ...) microbatched input; stage 0's copy is the one
    read (other stages' may hold zeros or anything).  Returns the
    final-stage outputs in the same microbatch layout, on every stage.

    Schedule: n_micro + pp - 1 ticks; at each tick every stage processes
    the microbatch it holds and passes the result to the next stage by one
    send (the bubble is (pp-1)/n_micro as usual).
    """
    pp, stage = group.size, group.index
    perm = [(i, i + 1) for i in range(pp - 1)]
    outputs = [torch.zeros_like(x_mb[0]) for _ in range(n_micro)]
    inflight = torch.zeros_like(x_mb[0])
    for t in range(n_micro + pp - 1):
        # stage 0 injects microbatch t (if any left)
        x_in = x_mb[t] if stage == 0 and t < n_micro else inflight
        y = stage_fn(stage, x_in)
        # pass to the next stage
        inflight = ppermute(y, group, perm)
        # last stage retires microbatch t - (pp - 1)
        out_idx = t - (pp - 1)
        if stage == pp - 1 and out_idx >= 0:
            outputs[out_idx] = y
    # only the last stage holds retired microbatches; broadcast to all
    return psum(torch.stack(outputs), group)
