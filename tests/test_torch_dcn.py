"""The port's DCN traffic engine (``repro_torch.dcn``) and control plane
(``repro_torch.core.control_plane``) against ``repro``'s.

The torch placement kernel runs with ``device="cpu"`` (its scans take the
prefix-scan wrapper's plain version) and must give placements bit-equal to
``repro.dcn.jax_backend.fat_tree_placements`` and to the NumPy kernel
``repro.dcn.kernel.batched_fat_tree``; the sweep grids, tables, the copied
NumPy kernels, the incremental orchestrator and ``ClusterManager`` must
equal ``repro``'s on the same inputs.  Every draw is seeded (NumPy at fixed
seeds); there are no hypothesis draws.  On the card ``chip_smoke.py`` holds
the same kernel, with the CUDA scan, to the port's numpy backend.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.dcn as R
from repro import obs as r_obs
from repro.core import control_plane as r_cp
from repro.dcn import jax_backend as r_jax
from repro.kernels.prefix_scan import host as r_host
import repro_torch.dcn as T
from repro_torch import obs as t_obs
from repro_torch.core import control_plane as t_cp
from repro_torch.core import arch as t_arch
from repro_torch.dcn import kernel as t_kernel
from repro_torch.dcn import torch_backend as tb
from repro_torch.kernels.prefix_scan import host as t_host

GRID_KEYS = ("groups", "dp_pairs", "crossing_pairs", "crossing_pod_pairs",
             "feasible")


def _masks(n, rows, ratios, seed):
    """Seeded fault masks: a fault-free row (every slot ties in the
    lexsort), an all-faulty row, then random rows at each ratio."""
    rng = np.random.default_rng(seed)
    out = [np.zeros(n, bool), np.ones(n, bool)]
    out += [rng.random(n) < r for r in ratios for _ in range(rows)]
    return np.stack(out)


def _assert_placements_equal(got, ref):
    assert got.need == ref.need and got.m == ref.m
    assert got.members.dtype == np.int32 and got.n_constraints.dtype == np.int64
    assert np.array_equal(got.members, np.asarray(ref.members))
    assert np.array_equal(got.feasible, np.asarray(ref.feasible))
    assert np.array_equal(got.n_constraints, np.asarray(ref.n_constraints))


def test_dcn_exports_what_repro_dcn_exports():
    assert T.__all__ == R.__all__
    assert all(hasattr(T, name) for name in R.__all__)


# ----------------------------------------------------- copied NumPy kernels


@pytest.mark.parametrize("shape", [(3, 0), (4, 1), (5, 128), (3, 129), (2, 7, 300),
                                   (2, 20000)])
def test_mask_cumsum_copy_matches_repro(shape):
    mask = np.random.default_rng(sum(shape)).random(shape) < 0.4
    got = t_host.mask_cumsum(mask)
    assert got.dtype == np.int32
    assert np.array_equal(got, r_host.mask_cumsum(mask))
    assert np.array_equal(got, np.cumsum(mask, axis=-1, dtype=np.int32))
    with pytest.raises(TypeError):
        t_host.mask_cumsum(mask.astype(np.int32))


@pytest.mark.parametrize("k,m", [(1, 4), (2, 3), (3, 8), (3, 16)])
def test_line_carves_match_repro(k, m):
    faulty = _masks(96, 3, (0.05, 0.2, 0.5), seed=k * 31 + m)
    assert np.array_equal(t_kernel.line_carve(faulty, k, m),
                          R.line_carve(faulty, k, m))
    assert np.array_equal(t_kernel.line_carve(faulty.reshape(11, 3, 32), k, m),
                          R.line_carve(faulty.reshape(11, 3, 32), k, m))
    avail = ~faulty
    assert np.array_equal(t_kernel.segment_placed_counts(avail, k, m),
                          R.kernel.segment_placed_counts(avail, k, m))
    for got, ref in zip(t_kernel.stream_placed_cols(avail, k, m),
                        R.kernel.stream_placed_cols(avail, k, m)):
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("tp", [16, 32])
def test_numpy_placement_kernels_match_repro(tp):
    n = 256
    masks = _masks(n, 3, (0.03, 0.12), seed=tp)
    cfg_t, cfg_r = T.FatTreeConfig(n, 4, 8, 64, 3), R.FatTreeConfig(n, 4, 8, 64, 3)
    job = int(n * 4 * 0.6) // tp * tp
    order = cfg_r.order()
    assert np.array_equal(cfg_t.order(), order)
    pairs = [
        (T.batched_fat_tree(masks, cfg_t, tp, job), R.batched_fat_tree(masks, cfg_r, tp, job)),
        (T.batched_greedy(masks, cfg_t, tp, job, seed=7, order=order),
         R.batched_greedy(masks, cfg_r, tp, job, seed=7, order=order)),
        (T.batched_dgx_island(masks, cfg_t, tp, job),
         R.batched_dgx_island(masks, cfg_r, tp, job)),
    ]
    for got, ref in pairs:
        _assert_placements_equal(got, ref)
        for key, val in T.batched_pair_counts(got, 8, 64).items():
            assert np.array_equal(val, R.batched_pair_counts(ref, 8, 64)[key]), key
        assert got.placement(2) == ref.placement(2)
    faults = set(np.nonzero(masks[3])[0].tolist())
    assert (T.dgx_island_placement(n, faults, tp // 4, 3)
            == R.dgx_island_placement(n, faults, tp // 4, 3))


def test_traffic_volumes_match_repro():
    assert dataclasses.asdict(T.LLAMA3_70B) == dataclasses.asdict(R.LLAMA3_70B)
    for tp, dp, kw in [(32, 64, {}), (8, 16, dict(global_batch=1024)), (1, 64, {}),
                       (32, 1, {}), (16, 8, dict(pp=2, micro_batch=2))]:
        assert T.dp_tp_bytes(T.LLAMA3_70B, tp, dp, **kw) == \
            R.dp_tp_bytes(R.LLAMA3_70B, tp, dp, **kw)
        assert T.dp_tp_ratio(T.LLAMA3_70B, tp, dp, **kw) == \
            R.dp_tp_ratio(R.LLAMA3_70B, tp, dp, **kw)
    with pytest.raises(ValueError):
        T.dp_tp_bytes(T.LLAMA3_70B, 0, 8)


def test_variant_for_matches_repro():
    for name in t_arch.names():
        assert T.variant_for(name) == R.variant_for(name)
    with pytest.raises(KeyError):
        T.variant_for("no-such-arch")


# ------------------------------------------------------ torch placement kernel

# (nodes, agg_domain, k, ratios): two regular geometries, fault ratios up to
# 30%; TP 16, 32 and 64 go through each in one call
GEOMETRIES = [(256, 64, 3, (0.0, 0.07, 0.15, 0.3)), (512, 128, 3, (0.03, 0.1, 0.3))]


@pytest.mark.parametrize("n,agg,k,ratios", GEOMETRIES)
def test_torch_fat_tree_matches_jax_and_numpy(n, agg, k, ratios):
    masks = _masks(n, 2, ratios, seed=n + agg)
    tps = (16, 32, 64)
    # 0.85 of the cluster, and a job larger than the cluster (infeasible)
    jobs = (int(n * 4 * 0.85) // 16 * 16, int(n * 4 * 0.85) // 32 * 32, n * 4 + 64)
    cfg_t, cfg_r = T.FatTreeConfig(n, 4, 8, agg, k), R.FatTreeConfig(n, 4, 8, agg, k)
    got = tb.fat_tree_placements(masks, cfg_t, tps, jobs, chunk_snapshots=5,
                                 device="cpu")
    ref_jax = r_jax.fat_tree_placements(masks, cfg_r, tps, jobs, chunk_snapshots=8)
    for ti, tp in enumerate(tps):
        ref = R.batched_fat_tree(masks, cfg_r, tp, jobs[ti])
        _assert_placements_equal(got[ti], ref)
        _assert_placements_equal(got[ti], ref_jax[ti])
        assert not got[ti].feasible[1]                 # the all-faulty row
    assert got[0].feasible[0] and got[1].feasible[0]   # the fault-free row
    assert not got[2].feasible.any()                   # the oversized job


def test_torch_fat_tree_awkward_geometry_matches_numpy():
    """m > chunk length, k = 1 and 2, m = 1, a line shorter than k."""
    n, agg = 128, 32                                   # 4 ToRs a domain
    masks = np.concatenate([_masks(n, 3, (0.1,), seed=5), (np.arange(n) % 9 == 0)[None]])
    for tp, k in ((64, 1), (4, 3), (32, 2), (16, 5)):
        cfg_t, cfg_r = T.FatTreeConfig(n, 4, 8, agg, k), R.FatTreeConfig(n, 4, 8, agg, k)
        job = int(n * 4 * 0.5) // tp * tp
        got = tb.fat_tree_placements(masks, cfg_t, [tp], [job], chunk_snapshots=2,
                                     device="cpu")[0]
        _assert_placements_equal(got, R.batched_fat_tree(masks, cfg_r, tp, job))


def test_torch_fat_tree_contracts():
    cfg = T.FatTreeConfig(128, 4, 8, 32, 3)
    empty = tb.fat_tree_placements(np.zeros((0, 128), bool), cfg, [16, 32], [256, 256],
                                   device="cpu")
    assert [e.members.shape for e in empty] == [(0, 16, 4), (0, 8, 8)]
    assert empty[0].feasible.shape == (0,) and empty[0].n_constraints.shape == (0,)
    with pytest.raises(ValueError, match="130 columns"):
        tb.fat_tree_placements(np.zeros((2, 130), bool), cfg, [16], [256], device="cpu")
    with pytest.raises(ValueError):
        r_jax.fat_tree_placements(np.zeros((2, 130), bool), R.FatTreeConfig(128, 4, 8, 32, 3),
                                  [16], [256])
    with pytest.raises(ValueError, match="regular"):
        tb.fat_tree_placements(np.zeros((2, 100), bool), T.FatTreeConfig(100, 4, 8, 64, 3),
                               [16], [256], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tb.fat_tree_placements(np.zeros((2, 128), bool), cfg, [16], [256])
        with pytest.raises(RuntimeError, match="CUDA"):
            T.run_dcn_sweep(T.DcnSpec(num_nodes=128, samples=2, agg_domain=32),
                            backend="torch")


@pytest.mark.parametrize("n,agg,tp,want", [(256, 64, 32, 26), (512, 128, 16, 26),
                                           (256, 32, 16, 30)])
def test_placement_scans_go_through_the_wrapper(monkeypatch, n, agg, tp, want):
    """Every prefix sum of the torch placement goes through the prefix-scan
    wrapper, ``4 * (iters + 1) + 2`` times a (block, TP), and nothing on the
    path calls ``torch.cumsum`` but the wrapper's plain version."""
    calls, inside = [0], [False]
    real_scan, real_cumsum = tb.prefix_scan, torch.cumsum

    def counting_scan(x):
        calls[0] += 1
        inside[0] = True
        try:
            return real_scan(x)
        finally:
            inside[0] = False

    def guarded_cumsum(*args, **kw):
        assert inside[0], "torch.cumsum called outside the prefix-scan wrapper"
        return real_cumsum(*args, **kw)

    monkeypatch.setattr(tb, "prefix_scan", counting_scan)
    monkeypatch.setattr(torch, "cumsum", guarded_cumsum)
    monkeypatch.setattr(torch.Tensor, "cumsum", guarded_cumsum)
    cfg = T.FatTreeConfig(n, 4, 8, agg, 3)
    iters = cfg.max_constraints.bit_length() + 1
    assert tb.search_iters(cfg) == iters
    assert tb.scans_per_call(cfg, tp) == 4 * (iters + 1) + 2 == want
    masks = _masks(n, 3, (0.07,), seed=1)             # 5 rows: blocks of 2, 2, 1
    job = int(n * 4 * 0.85) // tp * tp
    got = tb.fat_tree_placements(masks, cfg, [tp], [job], chunk_snapshots=2,
                                 device="cpu")[0]
    assert calls[0] == 3 * want
    monkeypatch.undo()
    _assert_placements_equal(got, R.batched_fat_tree(masks, R.FatTreeConfig(n, 4, 8, agg, 3),
                                                     tp, job))


# ------------------------------------------------------------------ the engine


def _specs(**kw):
    base = dict(num_nodes=256, fault_ratios=(0.0, 0.05, 0.07, 0.2), samples=4,
                tp_sizes=(16, 32), job_scale=0.85, agg_domain=64, seed=2)
    base.update(kw)
    return T.DcnSpec(**base), R.DcnSpec(**base)


def _assert_sweeps_equal(got, ref):
    assert got.variants == ref.variants
    assert np.array_equal(got.tp_sizes, ref.tp_sizes)
    for key in GRID_KEYS:
        g, r = getattr(got, key), getattr(ref, key)
        assert g.dtype == r.dtype and np.array_equal(g, r), key
    assert np.array_equal(got.n_constraints, ref.n_constraints)


def test_run_dcn_sweep_matches_repro_grids_and_tables():
    tspec, rspec = _specs()
    ref = R.run_dcn_sweep(rspec, backend="numpy")
    ref_jax = R.run_dcn_sweep(rspec, backend="jax")
    _assert_sweeps_equal(ref_jax, ref)
    runs = {"torch": T.run_dcn_sweep(tspec, backend="torch", device="cpu", chunk_snapshots=3),
            "numpy": T.run_dcn_sweep(tspec, backend="numpy")}
    for backend, got in runs.items():
        assert got.backend == backend
        _assert_sweeps_equal(got, ref)
        assert T.traffic_tables(got) == R.traffic_tables(ref)
        assert T.traffic_tables(got, dp_bytes=1.0, tp_bytes=9.0) == \
            R.traffic_tables(ref, dp_bytes=1.0, tp_bytes=9.0)
        for variant in T.VARIANTS:
            assert T.cross_tor_curve(got, variant, tp=32) == \
                R.cross_tor_curve(ref, variant, tp=32)
        for key, val in got.shares().items():
            assert np.array_equal(val, ref.shares()[key]), key
    assert got.ratio_index(0.07) == 2 and got.index("greedy") == 1
    scalar = T.run_dcn_sweep_scalar(dataclasses.replace(tspec, samples=2))
    ref_scalar = R.run_dcn_sweep_scalar(dataclasses.replace(rspec, samples=2))
    assert scalar.backend == "scalar"
    _assert_sweeps_equal(scalar, ref_scalar)
    for key in GRID_KEYS:
        assert np.array_equal(getattr(scalar, key), getattr(ref, key)[:, :, :2]), key


def test_run_dcn_sweep_given_masks_and_irregular_geometry():
    """Pre-drawn masks; a cluster whose domains do not tile it (the scalar
    fallback on every backend)."""
    tspec, rspec = _specs(num_nodes=250, fault_ratios=(0.06,), samples=3, tp_sizes=(16,))
    masks = [np.random.default_rng(9).random((3, 250)) < 0.06]
    ref = R.run_dcn_sweep(rspec, backend="numpy", masks=masks)
    _assert_sweeps_equal(T.run_dcn_sweep(tspec, backend="torch", device="cpu", masks=masks),
                         ref)
    _assert_sweeps_equal(T.run_dcn_sweep(tspec, backend="numpy", masks=masks), ref)


def test_evaluate_placements_matches_repro():
    n = 128
    masks = _masks(n, 2, (0.05, 0.2), seed=4)
    cfg_t, cfg_r = T.FatTreeConfig(n, 4, 8, 32, 3), R.FatTreeConfig(n, 4, 8, 32, 3)
    for variant in T.VARIANTS:
        got = T.evaluate_placements(masks, cfg_t, variant, 16, 256, backend="torch",
                                    greedy_seed=3, device="cpu")
        ref = R.evaluate_placements(masks, cfg_r, variant, 16, 256, backend="numpy",
                                    greedy_seed=3)
        _assert_placements_equal(got, ref)
    with pytest.raises(ValueError, match="unknown variant"):
        T.evaluate_placements(masks, cfg_t, "ring", 16, 256, backend="numpy")


def test_resolve_backend(monkeypatch):
    monkeypatch.delenv("REPRO_SWEEP_BACKEND", raising=False)
    assert T.resolve_backend("auto") == T.resolve_backend(None) == "torch"
    assert T.resolve_backend("numpy") == "numpy" and T.resolve_backend("torch") == "torch"
    with pytest.raises(ValueError):
        T.resolve_backend("jax")
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "numpy")
    assert T.resolve_backend("auto") == "numpy"
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "torch")
    assert T.resolve_backend(None) == "torch"
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "jax")
    with pytest.raises(ValueError):
        T.resolve_backend("auto")


# ---------------------------------------------- incremental and control plane


@pytest.mark.parametrize("seed", range(3))
def test_incremental_fat_tree_matches_repro(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([128, 256]))
    agg = int(rng.choice([32, 64]))
    k = int(rng.choice([2, 3]))
    tp = int(rng.choice([8, 16, 32]))
    inc_t = T.IncrementalFatTreeOrchestrator(n, 4, 8, agg, tp, k, faults={1, 2})
    inc_r = R.IncrementalFatTreeOrchestrator(n, 4, 8, agg, tp, k, faults={1, 2})
    faults = {1, 2}
    for _ in range(40):
        if faults and rng.random() < 0.45:
            u = int(sorted(faults)[rng.integers(len(faults))])
            faults.discard(u)
            inc_t.repair(u)
            inc_r.repair(u)
        else:
            u = int(rng.integers(n))
            faults.add(u)
            inc_t.fault(u)
            inc_r.fault(u)
        job = int(n * 4 * float(rng.choice([0.5, 0.85]))) // tp * tp
        assert inc_t.orchestrate(job) == inc_r.orchestrate(job)
        c = int(rng.integers(inc_t.cfg.max_constraints + 1))
        assert inc_t.capacity_groups(c) == inc_r.capacity_groups(c)
    assert inc_t.faults == inc_r.faults
    assert inc_t.events_applied == inc_r.events_applied
    with pytest.raises(ValueError):
        T.IncrementalFatTreeOrchestrator(100, 4, 8, 64, 16, 3)


@pytest.fixture
def telemetry():
    for o in (t_obs, r_obs):
        o.TELEMETRY.reset()
        o.TELEMETRY.enable()
    yield
    for o in (t_obs, r_obs):
        o.TELEMETRY.disable()
        o.TELEMETRY.reset()


def _plan_fields(plan):
    return (plan.placement, plan.segments_pos, plan.gpu_rings, plan.device_grid.tolist(),
            plan.axis_names, plan.deployment.order, plan.cross_tor)


@pytest.mark.parametrize("n,agg,tp,incremental", [(64, 32, 16, True), (64, 32, 16, False),
                                                  (100, 64, 16, True), (128, 32, 32, True)])
def test_cluster_manager_matches_repro(telemetry, n, agg, tp, incremental):
    """The same fault and repair events through both control planes: equal
    plans, settle times, logs and counters (regular and irregular
    geometry; a TP-size change rebuilds the trackers)."""
    rng = np.random.default_rng(n + tp)
    events = [("fault", {3, 4}), ("fault", {11}), ("repair", {4}),
              ("fault", {20, 21}), ("repair", {3})]
    events += [("fault", {int(u) for u in rng.choice(n, 2, replace=False)})
               for _ in range(4)]
    cms = [mod.ClusterManager(n, 4, k=3, nodes_per_tor=8, agg_domain=agg, seed=5,
                              incremental=incremental)
           for mod in (t_cp, r_cp)]
    for i, (kind, nodes) in enumerate(events):
        evs = []
        for cm in cms:
            fn = cm.on_fault if kind == "fault" else cm.on_repair
            # the last event runs at another TP size
            evs.append(fn(60.0 * i, set(nodes), tp_size=tp if i < 8 else tp // 2,
                          dp_size=8))
        a, b = evs
        assert (a.time_s, a.kind, a.nodes, a.settle_s) == (b.time_s, b.kind, b.nodes, b.settle_s)
        assert _plan_fields(a.plan) == _plan_fields(b.plan)
    t_cm, r_cm = cms
    assert t_cm.physical_faults == r_cm.physical_faults
    assert len(t_cm.log) == len(r_cm.log) == len(events)
    assert t_cm.placeable_gpus(tp) == r_cm.placeable_gpus(tp)
    times = {u: 1.0 + (u % 7 == 0) for u in range(n)}
    assert t_cm.flag_stragglers(times) == r_cm.flag_stragglers(times)
    assert t_cm.flag_stragglers({}) == set()
    assert t_obs.TELEMETRY.counters == r_obs.TELEMETRY.counters
    assert any(name.startswith("control_plane.") for name in t_obs.TELEMETRY.counters)


def test_cluster_manager_infeasible_and_fabric_managers():
    for mod in (t_cp, r_cp):
        cm = mod.ClusterManager(32, 4, k=3, nodes_per_tor=8, agg_domain=32)
        with pytest.raises(Exception, match="cannot host"):
            cm.on_fault(0.0, set(range(0, 32, 2)), tp_size=32, dp_size=2)
    cfg_t = t_cp.ControlPlaneConfig(protocol_delay_us=10.0, heartbeat_interval_s=2.0)
    cfg_r = r_cp.ControlPlaneConfig(protocol_delay_us=10.0, heartbeat_interval_s=2.0)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_r)
    assert cfg_t.heartbeat_timeout_s == cfg_r.heartbeat_timeout_s == 6.0
    cms = [mod.ClusterManager(64, 4, agg_domain=32, config=cfg)
           for mod, cfg in ((t_cp, cfg_t), (r_cp, cfg_r))]
    out = []
    for cm in cms:
        fab = cm.fabric[5]
        fab.heartbeat(1.0)
        cm.on_fault(3.0, {9}, tp_size=16, dp_size=4)
        out.append((fab.alive(4.0), fab.alive(7.5), cm.fabric[9].alive(3.5),
                    cm.log[-1].settle_s))
    assert out[0] == out[1] == (True, False, False, out[0][3])
