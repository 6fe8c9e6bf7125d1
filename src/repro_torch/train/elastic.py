"""Elastic fault-tolerant training runtime, the counterpart of
``repro/train/elastic.py``.

Wires the paper's control plane into the training loop:

  1. ``ClusterManager`` watches for fault events (injected by tests or a
     fault trace);
  2. on a fault it re-runs the HBD-DCN orchestrator on the healthy
     subgraph, yielding a new ``MeshPlan`` (possibly with a smaller DP
     degree -- elastic scaling) and the OCSTrx settle time;
  3. the runtime restores the latest checkpoint into the state built for
     the new mesh (``checkpoint.restore`` overwrites it in place) and
     resumes from the saved step.

Straggler mitigation rides the same path: ranks flagged by
``ClusterManager.flag_stragglers`` are treated as faults at the next ring
rebuild (the K-hop backup links make the swap a bypass, not a re-wiring).

The mesh is a ``DeviceMesh`` over the ``torch.distributed`` world when the
world holds every rank the plan names; a smaller world (one process, as in
the tests and on one card) keeps ``mesh=None`` and the plan still drives
placement, as ``repro`` does with too few JAX devices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Set

import torch.distributed as dist

from repro_torch.core.control_plane import ClusterManager
from repro_torch.core.placement import InsufficientCapacityError, MeshPlan, \
    make_orchestrated_mesh
from repro_torch.parallel.mesh import device_type
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class ElasticConfig:
    num_nodes: int
    gpus_per_node: int = 4
    k: int = 3
    tp_size: int = 16
    dp_size: int = 4
    pod_size: int = 1
    nodes_per_tor: int = 8
    agg_domain: int = 64
    checkpoint_every: int = 20
    straggler_threshold: float = 1.5


class ElasticRunner:
    """Drives train steps under fault events.

    ``build_step(mesh, plan, dp_size)`` must return (state, step_fn,
    data_iter) for the given mesh -- the runner stays model-agnostic.
    ``device`` is the device type of the meshes it builds; the default,
    ``"cuda"``, raises without a card.
    """

    def __init__(self, cfg: ElasticConfig, ckpt_dir, build_step: Callable, *,
                 device="cuda"):
        self.device = device_type(device)
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.build_step = build_step
        self.cm = ClusterManager(cfg.num_nodes, cfg.gpus_per_node, cfg.k,
                                 cfg.nodes_per_tor, cfg.agg_domain)
        self.events = []
        self.step_times: Dict[int, float] = {}

    def _build_mesh(self, plan: MeshPlan):
        """The ``DeviceMesh`` of the plan when the world has enough ranks
        (production); smaller worlds keep mesh=None -- the plan still
        drives placement."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world >= plan.device_grid.size:
            return make_orchestrated_mesh(plan, world, device=self.device)
        return None

    def _mesh_for(self, dp_size: int):
        ev = self.cm._replan(time.time(), (), "replan", self.cfg.tp_size,
                             dp_size, self.cfg.pod_size)
        plan = ev.plan
        return self._build_mesh(plan), plan, ev

    def run(self, total_steps: int,
            fault_schedule: Optional[Dict[int, Set[int]]] = None,
            repair_schedule: Optional[Dict[int, Set[int]]] = None,
            straggler_schedule: Optional[Dict[int, Dict[int, float]]] = None):
        """Run ``total_steps``, applying faults at the scheduled steps.

        ``straggler_schedule`` maps a step to that step's observed per-node
        step times (``{node: seconds}`` -- in production, the per-rank
        timings the heartbeats carry).  The times are fed to
        ``ClusterManager.flag_stragglers``; nodes exceeding
        ``straggler_threshold`` x median are treated exactly like faults at
        that step (ring rebuild + checkpoint restore), per the paper's
        straggler-mitigation path.
        """
        # copy: events fire exactly once (a rollback past the fault step
        # must not re-trigger the same fault)
        fault_schedule = dict(fault_schedule or {})
        repair_schedule = dict(repair_schedule or {})
        straggler_schedule = dict(straggler_schedule or {})
        dp = self.cfg.dp_size
        mesh, plan, _ = self._mesh_for(dp)
        state, step_fn, data = self.build_step(mesh, plan, dp)
        saver = ckpt.AsyncCheckpointer(self.ckpt_dir)
        step = 0
        losses = []
        while step < total_steps:
            if step in repair_schedule:
                self.cm.on_repair(time.time(), repair_schedule.pop(step),
                                  self.cfg.tp_size, dp, self.cfg.pod_size)
            fault_nodes: Set[int] = set()
            if step in fault_schedule:
                fault_nodes |= set(fault_schedule.pop(step))
            if step in straggler_schedule:
                flagged = self.cm.flag_stragglers(
                    straggler_schedule.pop(step),
                    self.cfg.straggler_threshold)
                flagged -= self.cm.physical_faults
                if flagged:
                    self.events.append(("straggler", step,
                                        tuple(sorted(flagged))))
                    fault_nodes |= flagged
            if fault_nodes:
                # 1) mark faults + reconfigure rings (control plane); a plan
                # that no longer fits raises InsufficientCapacityError
                saver.wait()
                ev = self.cm.on_fault(time.time(), fault_nodes,
                                      self.cfg.tp_size, dp,
                                      self.cfg.pod_size)
                new_dp = ev.plan.device_grid.shape[-2]
                self.events.append(("fault", step, ev.settle_s - ev.time_s))
                # 2) rebuild mesh + restore from latest checkpoint
                dp = new_dp
                mesh = self._build_mesh(ev.plan)
                state, step_fn, data = self.build_step(mesh, ev.plan, dp)
                last = ckpt.latest_step(self.ckpt_dir)
                if last is not None:
                    state = ckpt.restore(self.ckpt_dir, state)
                    step = last + 1

            t0 = time.perf_counter()
            batch = next(data)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            self.step_times[step] = time.perf_counter() - t0
            if (step + 1) % self.cfg.checkpoint_every == 0:
                saver.save_async(state, step)
            step += 1
        saver.wait()
        return state, losses


