"""The port's copies of ``repro.core``'s host modules against the originals:
OCSTrx, the K-hop ring topology, the orchestrator (Algorithms 2-5, the
greedy baseline, the incremental orchestrator, cross-ToR traffic), the
host part of placement, the fault simulator and the MFU simulator.

The same inputs go through both packages and the results must be equal:
these modules are integer and float64 host code, copied, so they agree
exactly.  Every draw is seeded (``numpy`` or ``random`` at fixed seeds);
there are no hypothesis draws here.
"""

import random

import numpy as np
import pytest

from repro.core import fault_sim as j_fault_sim
from repro.core import hbd_models as j_hbd
from repro.core import mfu_sim as j_mfu
from repro.core import ocstrx as j_ocstrx
from repro.core import orchestrator as j_orch
from repro.core import placement as j_place
from repro.core import topology as j_topo
from repro.core import trace as j_trace
from repro_torch import core as t_core
from repro_torch.core import fault_sim as t_fault_sim
from repro_torch.core import hbd_models as t_hbd
from repro_torch.core import mfu_sim as t_mfu
from repro_torch.core import ocstrx as t_ocstrx
from repro_torch.core import orchestrator as t_orch
from repro_torch.core import placement as t_place
from repro_torch.core import topology as t_topo
from repro_torch.core import trace as t_trace


def _faults(n, count, seed):
    return set(np.random.default_rng(seed).choice(n, count, replace=False).tolist())


def test_core_exports_what_repro_core_exports_but_the_mesh_and_control_plane():
    import repro.core as j_core

    public = {n for n in dir(j_core) if not n.startswith("_")}
    modules = {n for n in public if type(getattr(j_core, n)).__name__ == "module"}
    # the mesh builder came with the parallel slice: now nothing is left out
    assert public - modules <= set(dir(t_core))
    assert callable(t_core.make_orchestrated_mesh)
    # the control plane came with the DCN slice
    assert {"ClusterManager", "ControlPlaneConfig", "NodeFabricManager",
            "ReconfigEvent"} <= set(dir(t_core))


# ------------------------------------------------------------------ OCSTrx


def test_ocstrx_switching_matches_repro():
    """Path switches, settle times with a seeded latency draw, failure,
    power and bandwidth of a bundle."""
    out = []
    for mod in (j_ocstrx, t_ocstrx):
        rng = np.random.default_rng(5)
        b = mod.OCSTrxBundle("b0", width=8)
        times = [b.switch_all(mod.Path.EXT1, 0.0, rng),
                 b.switch_all(mod.Path.EXT2, 10.0, rng),
                 b.switch_all(mod.Path.EXT2, 20.0, rng),
                 b.switch_all(mod.Path.LOOPBACK, 500.0, None, (5.0, 9.0))]
        b.modules[3].fail()
        times.append(b.switch_all(mod.Path.EXT1, 900.0, rng))
        out.append((times, [m.active.name for m in b.modules],
                    [m.reconfig_count for m in b.modules], b.healthy, b.bandwidth_gbps,
                    b.power_w, mod.insertion_loss_db(60.0),
                    mod.bit_error_rate(-3.0, 40.0), b.modules[0].link_budget_ok()))
    assert out[0] == out[1]


# ---------------------------------------------------------------- topology


@pytest.mark.parametrize("closed", [True, False], ids=["ring", "line"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_k_hop_components_neighbors_and_waste_match_repro(closed, k):
    res = []
    for mod in (j_topo, t_topo):
        topo = mod.KHopRingTopology(mod.TopologyConfig(64, 4, k, closed_ring=closed))
        topo.inject_faults(sorted(_faults(64, 9, seed=k)) + [0, 63, 62])
        comps = topo.healthy_components()
        topo.repair([62])
        res.append((comps, topo.healthy_components(), [topo.neighbors(u) for u in (0, 5, 63)],
                    topo.edges(), topo.distance(1, 60), topo.waste_report(4),
                    topo.healthy_nodes()))
    assert res[0] == res[1]


def test_gpu_ring_and_activate_segment_match_repro():
    res = []
    for mod in (j_topo, t_topo):
        topo = mod.KHopRingTopology(mod.TopologyConfig(16, 4, 3))
        topo.inject_faults([2])
        rng = np.random.default_rng(9)
        settle = [topo.activate_segment([0, 1, 3, 4]),
                  topo.activate_segment([5, 6, 8], now_us=100.0, rng=rng),
                  topo.activate_segment([9, 10], now_us=200.0, latency_range=(1.0, 2.0))]
        with pytest.raises(ValueError):
            topo.bypass_plan([0, 4])
        res.append((topo.gpu_ring([0, 1, 3, 4]), topo.gpu_ring([7]), settle,
                    topo.bypass_plan([0, 1, 3, 4]),
                    [[m.active.name for m in b.modules] for b in topo.bundles[3]]))
    assert res[0] == res[1]
    assert 0 < res[1][2][0] <= 100.0


# ------------------------------------------------------------ orchestrator


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fat_tree_greedy_and_dcn_free_placements_match_repro(seed):
    faults = _faults(256, 6 + 4 * seed, seed)
    res = []
    for mod in (j_orch, t_orch):
        dep = mod.deployment_strategy(256, 8)
        opt = mod.orchestrate_fat_tree(256, 4, 8, faults, tp_size=16, job_gpus=192 * 4,
                                       agg_domain=64, k=3)
        base = mod.greedy_baseline(256, 4, faults, 16, 192 * 4, k=3, seed=seed,
                                   order=dep.order)
        res.append((dep.order, dep.sublines, opt, base,
                    mod.orchestrate_dcn_free(dep.order, faults, 4, 3),
                    [mod.placement_fat_tree(dep, c, faults, 4, 64, 3) for c in range(3)],
                    mod.healthy_components(dep.order, faults, 3),
                    mod.cross_tor_traffic(opt, 8), mod.cross_tor_traffic(base, 8),
                    mod.cross_tor_traffic(opt, 8, agg_domain=64),
                    mod.traffic_pair_counts(base, 8, 64)))
    assert res[0] == res[1]


def test_incremental_orchestrator_matches_repro_over_events():
    """The same fault and repair events, drawn from a seeded ``random``
    stream, give the same placements and capacities after every event."""
    order = j_orch.deployment_strategy(128, 8).order
    rng = random.Random(4)
    events = [(rng.random() < 0.6, rng.randrange(128)) for _ in range(120)]
    engines = [mod.IncrementalOrchestrator(order, 4, 3, faults={3, 4})
               for mod in (j_orch, t_orch)]
    for is_fault, node in events:
        for eng in engines:
            (eng.fault if is_fault else eng.repair)(node)
        a, b = engines
        assert (a.placement(), a.capacity_groups(), a.capacity_nodes(), a.faults) == \
            (b.placement(), b.capacity_groups(), b.capacity_nodes(), b.faults)
    assert engines[1].placement() == t_orch.orchestrate_dcn_free(
        order, engines[1].faults, 4, 3)
    assert engines[0].events_applied == engines[1].events_applied > 0


# --------------------------------------------------------------- placement


@pytest.mark.parametrize("orchestrated", [True, False])
def test_plan_mesh_matches_repro(orchestrated):
    plans = [mod.plan_mesh(256, 4, 16, 14, 2, faults={3, 77, 150}, k=3,
                           orchestrated=orchestrated, seed=1) for mod in (j_place, t_place)]
    a, b = plans
    np.testing.assert_array_equal(a.device_grid, b.device_grid)
    assert (a.placement, a.segments_pos, a.gpu_rings, a.axis_names, a.cross_tor) == \
        (b.placement, b.segments_pos, b.gpu_rings, b.axis_names, b.cross_tor)
    assert (a.deployment.order, a.deployment.sublines) == \
        (b.deployment.order, b.deployment.sublines)
    for k in (1, 2, 3):
        assert j_place.ring_adjacency_ok(a, k, 4) == t_place.ring_adjacency_ok(b, k, 4)
    assert t_place.ring_adjacency_ok(b, 3, 4)
    one_pod = t_place.plan_mesh(128, 4, 16, 7, faults={9}, k=3)
    assert one_pod.device_grid.shape == (7, 16) and one_pod.axis_names == ("data", "model")


def test_plan_mesh_raises_on_insufficient_capacity_like_repro():
    for mod in (j_place, t_place):
        with pytest.raises(mod.InsufficientCapacityError, match="need 32 TP groups"):
            mod.plan_mesh(128, 4, tp_size=16, dp_size=16, pod_size=2,
                          faults={1, 2, 3}, k=3)
    assert issubclass(t_place.InsufficientCapacityError, RuntimeError)


# --------------------------------------------------------------- fault sim


def _models(mod, n=720):
    return [mod.InfiniteHBDModel(n, 4, k=3), mod.NVLModel(n, 4, hbd_gpus=72),
            mod.TPUv4Model(n, 4)]


def test_fault_sim_waste_numbers_match_repro():
    """Trace waste (scalar and batched), waste against the fault ratio, the
    largest job and the waiting share, for three HBD models."""
    traces = [mod.to_4gpu_trace(mod.generate_trace(400, seed=1)) for mod in (j_trace, t_trace)]
    res = []
    for hbd, fs, tr in ((j_hbd, j_fault_sim, traces[0]), (t_hbd, t_fault_sim, traces[1])):
        row = []
        for m in _models(hbd):
            s = fs.waste_over_trace(m, tr, 32, 100)
            row.append((s.name, s.mean_waste, s.p50_waste, s.p99_waste, s.series.tolist()))
            row.append([(x.tp_size, x.mean_waste, x.p99_waste) for x in
                        fs.waste_over_trace_batched(m, tr, [8, 32, 64], 100)])
            row.append(fs.waste_vs_fault_ratio(m, 32, [0.01, 0.05], samples=5, seed=2))
            row.append(fs.waste_vs_fault_ratio_batched(m, 32, [0.01, 0.05], samples=5, seed=2))
            row.append((fs.max_job_scale(m, tr, 32, 60),
                        fs.max_job_scale_batched(m, tr, [16, 32], 60)))
            row.append((fs.fault_waiting_time(m, tr, 32, 2700, 60),
                        fs.fault_waiting_time_batched(m, tr, 32, [2600, 2700, 2800], 60)))
        row.append(fs.theoretical_waste_bound(32, 4, 3, 0.0367))
        res.append(row)
    assert res[0] == res[1]
    inf = res[1][0]
    assert inf[1] < 0.01                   # InfiniteHBD's waste at TP-32 stays near zero


# ----------------------------------------------------------------- MFU sim


@pytest.mark.parametrize("case", [
    ("llama", 1024, {}), ("llama", 131072, {}), ("llama", 131072, {"max_tp": 8}),
    ("moe", 4096, {"eps": (1, 2, 4, 8), "imbalance": 0.2}),
    ("moe", 4096, {"eps": (8,), "imbalance": 0.0}),
], ids=["405B 1k", "405B 128k", "405B 128k TP-8", "MoE EP<=8 imbalanced", "MoE EP 8"])
def test_mfu_search_finds_repro_best_plan(case):
    name, gpus, kw = case
    kw = dict(kw)
    cluster_kw = {"max_tp": kw.pop("max_tp")} if "max_tp" in kw else {}
    if name == "moe":
        kw.update(global_batch=1536, vpp=3)
    res = []
    for mod in (j_mfu, t_mfu):
        model = mod.LLAMA31_405B if name == "llama" else mod.GPT_MOE_1T
        r = mod.search(model, mod.Cluster(gpus, **cluster_kw), **kw)
        again = mod.simulate(model, mod.Cluster(gpus, **cluster_kw), r.plan,
                             global_batch=kw.get("global_batch", 2048),
                             imbalance=kw.get("imbalance", 0.0))
        res.append((r.plan, r.mfu, r.step_time_s, r.breakdown, again.mfu))
    (jp, *jrest), (tp, *trest) = res
    assert (jp.tp, jp.pp, jp.dp, jp.ep) == (tp.tp, tp.pp, tp.dp, tp.ep)
    assert jrest == trest
