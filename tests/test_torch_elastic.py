"""The port's elastic runtime, orchestrated mesh and production meshes
against ``repro``'s, on the CPU.

``repro_torch.train.elastic.ElasticRunner`` repeats the three elastic tests
of ``tests/test_system.py`` (a fault mid-run, a straggler schedule, a
straggler already faulty) on ``device="cpu"``, training reduced H2O-Danube.
``repro``'s runner runs the same schedules over a stand-in step (its events
come from the control plane and the schedules alone), and the two must
record the same events (kinds, steps, straggler nodes), build the same
meshes (DP degrees, plan shapes, rank grids) and leave the same
checkpoints; settle times are held to their bound, not to each other.
The recomputed steps after the rollback must give the first pass's losses.

The orchestrated rank grid equals ``repro``'s ``plan_mesh(...).device_grid``
and the production grids at 512 ranks pass ``tests/_prod_mesh_check.py``'s
orchestration checks, without a process group.
"""

import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.placement import InsufficientCapacityError as JaxCapacityError
from repro.core.placement import plan_mesh as jax_plan_mesh
from repro.train.elastic import ElasticConfig as JaxElasticConfig
from repro.train.elastic import ElasticRunner as JaxElasticRunner
from repro_torch.configs import get_arch
from repro_torch.core.placement import (InsufficientCapacityError, orchestrated_grid,
                                        plan_mesh, ring_adjacency_ok)
from repro_torch.launch.mesh import orchestrated_production_plan, production_grid
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import synthetic_batch
from repro_torch.train.elastic import ElasticConfig, ElasticRunner

CFG = get_arch("h2o-danube").reduced()
TCFG = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))

_straggle = {i: 1.0 for i in range(8)}
_straggle[5] = 3.0                       # node 5 straggles at step 4
_slow = {i: 1.0 for i in range(8)}
_slow[3] = 9.0
# (total steps, checkpoint_every, batch, seq, fault, straggler schedules)
SCHEDULES = {
    "fault": (18, 5, 4, 32, {9: {3, 4}}, None),
    "straggler": (10, 3, 2, 16, None, {4: _straggle}),
    "straggler_already_faulty": (8, 3, 2, 16, {2: {3}}, {5: _slow}),
}


def _port_run(name, d):
    total, every, batch, seq, faults, stragglers = SCHEDULES[name]
    built = []

    def build_step(mesh, plan, dp):
        built.append((mesh, plan.device_grid.copy(), dp))
        state = init_train_state(CFG, TCFG, 0, device="cpu")
        # the same batch every step: a step's loss then depends only on the
        # state, so the steps recomputed after a rollback repeat their losses
        b = {k: torch.from_numpy(v) for k, v in synthetic_batch(CFG, 0, batch, seq).items()}
        return state, make_train_step(CFG, TCFG), iter(lambda: b, None)

    runner = ElasticRunner(ElasticConfig(num_nodes=64, gpus_per_node=4, tp_size=16,
                                         dp_size=14, checkpoint_every=every), d, build_step,
                           device="cpu")
    state, losses = runner.run(total_steps=total, fault_schedule=faults,
                               straggler_schedule=stragglers)
    return runner, built, losses


def _jax_run(name, d):
    total, every, _, _, faults, stragglers = SCHEDULES[name]
    built = []

    def build_step(mesh, plan, dp):
        built.append((mesh, plan.device_grid.copy(), dp))
        return ({"w": jnp.zeros(4)}, lambda s, b: (s, {"loss": jnp.float32(1.0)}),
                iter(lambda: None, 0))

    runner = JaxElasticRunner(JaxElasticConfig(num_nodes=64, gpus_per_node=4, tp_size=16,
                                               dp_size=14, checkpoint_every=every),
                              d, build_step)
    _, losses = runner.run(total_steps=total, fault_schedule=faults,
                           straggler_schedule=stragglers)
    return runner, built, losses


def _saved(d):
    return sorted(p.name for p in Path(d).glob("step*.npz"))


@pytest.fixture(scope="module", params=sorted(SCHEDULES))
def runs(request):
    with tempfile.TemporaryDirectory() as dp, tempfile.TemporaryDirectory() as dj:
        port = _port_run(request.param, dp)
        ref = _jax_run(request.param, dj)
        yield request.param, port, ref, _saved(dp), _saved(dj), ckpt.latest_step(dp)


def test_events_equal_repro(runs):
    name, (runner, _, _), (jrunner, _, _), _, _, _ = runs
    strip = [(e[0], e[1]) + ((e[2],) if e[0] == "straggler" else ()) for e in runner.events]
    jstrip = [(e[0], e[1]) + ((e[2],) if e[0] == "straggler" else ()) for e in jrunner.events]
    assert strip == jstrip and strip
    assert len([e for e in runner.events if e[0] == "fault"]) == 1
    # reconfiguration settle time recorded and tiny (OCSTrx ~80us + sw)
    for e in runner.events + jrunner.events:
        if e[0] == "fault":
            assert 0 < e[2] < 0.01
    assert runner.cm.physical_faults == jrunner.cm.physical_faults
    if name == "straggler":
        assert [e for e in runner.events if e[0] == "straggler"] == [("straggler", 4, (5,))]
        assert 5 in runner.cm.physical_faults
    if name == "straggler_already_faulty":
        assert [e for e in runner.events if e[0] == "straggler"] == []


def test_meshes_and_dp_degrees_equal_repro(runs):
    _, (_, built, _), (_, jbuilt, _), _, _, _ = runs
    assert [dp for _, _, dp in built] == [dp for _, _, dp in jbuilt]
    assert all(np.array_equal(g, jg) for (_, g, _), (_, jg, _) in zip(built, jbuilt))
    # one process: the world is smaller than every plan, so no mesh is built
    assert all(m is None for m, _, _ in built) and all(m is None for m, _, _ in jbuilt)


def test_checkpoints_equal_repro_and_the_rollback_repeats_losses(runs):
    name, (_, _, losses), (_, _, jlosses), saved, jsaved, last = runs
    total = SCHEDULES[name][0]
    assert saved == jsaved and saved and last is not None
    assert len(losses) == len(jlosses) >= total
    assert all(np.isfinite(losses))
    # the steps replayed after the rollback: the fault step f came after the
    # checkpoint at step c, so steps c+1 .. f-1 ran twice
    fault_step = next(e[1] for e in runs[1][0].events if e[0] == "fault")
    every = SCHEDULES[name][1]
    c = (fault_step // every) * every - 1
    first = losses[c + 1:fault_step]
    again = losses[fault_step:fault_step + len(first)]
    assert first == again and losses[fault_step - 1] != losses[c]


@pytest.mark.parametrize("case", [(128, 4, 16, 15, 2, {7, 99}), (64, 4, 16, 14, 1, {3, 4}),
                                  (8, 1, 2, 2, 1, set())])
def test_plan_grids_equal_repro(case):
    nodes, gpn, tp, dp, pod, faults = case
    plan = plan_mesh(nodes, gpn, tp_size=tp, dp_size=dp, pod_size=pod, faults=faults, k=3)
    jplan = jax_plan_mesh(nodes, gpn, tp_size=tp, dp_size=dp, pod_size=pod, faults=faults, k=3)
    assert np.array_equal(plan.device_grid, jplan.device_grid)
    assert plan.axis_names == jplan.axis_names
    grid = orchestrated_grid(plan, nodes * gpn)
    assert grid is plan.device_grid
    with pytest.raises(InsufficientCapacityError, match="but only"):
        orchestrated_grid(plan, int(plan.device_grid.max()))


def test_production_grids_at_512_ranks():
    """tests/_prod_mesh_check.py's orchestration checks, on the host."""
    g1, a1 = production_grid()
    g2, a2 = production_grid(multi_pod=True)
    assert g1.size == 256 and g2.size == 512 and g2.shape == (2, 16, 16)
    assert a1 == ("data", "model") and a2 == ("pod", "data", "model")
    # 128 nodes (the 512 ranks), 2 faulty -> elastic dp=15 keeps 30 rings
    plan = plan_mesh(128, 4, tp_size=16, dp_size=15, pod_size=2, faults={7, 99}, k=3)
    assert ring_adjacency_ok(plan, 3, 4)
    grid = orchestrated_grid(plan, 512)
    assert grid.shape == (2, 15, 16)
    assert len(set(grid.reshape(-1).tolist())) == 480  # faulty nodes' GPUs excluded
    assert not {7 * 4 + i for i in range(4)} & set(grid.reshape(-1).tolist())
    # the full production plan: all 128 nodes, and none to spare for faults
    full = orchestrated_production_plan(512, multi_pod=True)
    assert np.array_equal(full.device_grid, jax_plan_mesh(128, 4, 16, 16, 2).device_grid)
    with pytest.raises(InsufficientCapacityError):
        orchestrated_production_plan(512, multi_pod=True, faults={7, 99})
    with pytest.raises(JaxCapacityError):
        jax_plan_mesh(128, 4, 16, 16, 2, faults={7, 99})
