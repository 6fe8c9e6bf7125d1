"""The port's cost engine (``repro_torch.cost``) and ``comparison_matrix``
against ``repro``'s.

The waste sweeps under the cost grids and the matrix run through the port's
scenario and DCN engines with ``backend="torch", device="cpu"`` (and
``backend="numpy"``); every integer grid must equal ``repro``'s with
``np.array_equal`` and every float64 result with ``==`` (``None`` in the
same places).  Inputs are seeded; there are no hypothesis draws.  On the
card ``chip_smoke.py`` holds the same engines to the port's numpy backend
and to ``BENCH_cost.json`` / ``BENCH_matrix.json`` at the benchmarks'
sizes.
"""

import numpy as np
import pytest
import torch

import repro.cost as R
from repro.churn import replay_trace as r_replay_trace
from repro.churn import ChurnSpec as RChurnSpec
from repro.core.cost_model import bom_for as r_bom_for
from repro.core.mfu_sim import SimModel as RSimModel
from repro.sim.tables import comparison_matrix as r_comparison_matrix
import repro_torch.cost as T
from repro_torch.churn import ChurnSpec as TChurnSpec
from repro_torch.churn import replay_trace as t_replay_trace
from repro_torch.core.cost_model import (BOM_REGISTRY, aggregate_cost,
                                         bom_for)
from repro_torch.core.mfu_sim import SimModel as TSimModel
from repro_torch.sim import comparison_matrix

SPEC = dict(num_nodes=128, fault_ratios=(0.0, 0.05, 0.12), samples=6,
            tp_sizes=(8, 32), seed=5,
            architectures=T.DEFAULT_COST_ARCHITECTURES + ("rail-only", "railx"))
GRIDS = ("total_gpus", "faulty_gpus", "placed_gpus", "cost_usd")
TINY = dict(name="tiny", layers=8, hidden=1024, ffn=4096, vocab=32000, heads=16, seq=2048)


def _assert_results_equal(got, ref):
    assert got.names == ref.names
    for field in ("fault_ratios", "tp_sizes", *GRIDS):
        g, r = getattr(got, field), getattr(ref, field)
        assert g.dtype == r.dtype and np.array_equal(g, r), field


def test_cost_exports_what_repro_cost_exports():
    assert T.__all__ == R.__all__
    assert all(hasattr(T, name) for name in R.__all__)
    assert T.DEFAULT_COST_ARCHITECTURES == R.DEFAULT_COST_ARCHITECTURES


@pytest.mark.parametrize("include_hpn", [False, True])
def test_table6_and_headline_ratios_match_repro(include_hpn):
    assert T.per_gpu_cost_table(include_hpn) == R.per_gpu_cost_table(include_hpn)
    assert T.headline_ratio_rows() == R.headline_ratio_rows()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_grid_matches_repro_on_random_grids(seed):
    rng = np.random.default_rng(seed)
    names = ("infinitehbd-k2", "infinitehbd-k3", "nvl-72", "tpuv4", "dgx-h100")
    total = rng.integers(0, 5000, size=(len(names), 3))
    placed = np.minimum(rng.integers(0, 5000, size=(len(names), 11, 3)), total[:, None, :])
    unit = float(rng.uniform(1e3, 5e4))
    got = T.cost_grid(total, placed, [bom_for(n) for n in names], gpu_unit_cost=unit)
    ref = R.cost_grid(total, placed, [r_bom_for(n) for n in names], gpu_unit_cost=unit)
    assert got.dtype == np.float64 and np.array_equal(got, ref)
    # the scalar §6.5 formula, cell by cell
    for a, name in enumerate(names):
        stranded = total[a][None, :] - placed[a]
        want = [[aggregate_cost(bom_for(name), int(total[a, t]), int(stranded[s, t]), 0, unit)
                 for t in range(3)] for s in range(11)]
        assert np.array_equal(got[a], np.array(want))


def test_cost_grid_rejects_bom_mismatch():
    with pytest.raises(ValueError, match="BOMs"):
        T.cost_grid(np.zeros((2, 1)), np.zeros((2, 3, 1)), [bom_for("nvl-72")])


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_run_cost_sweep_matches_repro_and_scalar(backend):
    got = T.run_cost_sweep(T.CostSpec(**SPEC), backend=backend, device="cpu",
                           chunk_snapshots=4)
    assert got.backend == backend and got.num_snapshots == 6
    ref = R.run_cost_sweep(R.CostSpec(**SPEC), backend="numpy")
    _assert_results_equal(got, ref)
    scalar = T.run_cost_sweep_scalar(T.CostSpec(**SPEC), max_samples=3)
    assert np.array_equal(scalar.total_gpus, got.total_gpus)
    for field in GRIDS[1:]:
        assert np.array_equal(getattr(scalar, field), getattr(got, field)[:, :, :3]), field
    assert np.array_equal(got.stranded_gpus, ref.stranded_gpus)
    assert np.array_equal(got.mean_cost_usd, ref.mean_cost_usd)
    assert got.ratio_index(0.05) == 1 and got.tp_index(32) == 1 and got.index("railx") == 6


def test_run_cost_sweep_matches_repro_jax(canonical_jax_draws):
    got = T.run_cost_sweep(T.CostSpec(**SPEC), backend="torch", device="cpu")
    _assert_results_equal(got, R.run_cost_sweep(R.CostSpec(**SPEC), backend="jax"))


@pytest.fixture
def canonical_jax_draws():
    """``jax.random`` in the original threefry layout, the canonical stream
    (this JAX release defaults to the partitionable one)."""
    import jax
    old = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", False)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def test_cost_tables_match_repro():
    got = T.run_cost_sweep(T.CostSpec(**SPEC), device="cpu")
    ref = R.run_cost_sweep(R.CostSpec(**SPEC), backend="numpy")
    assert T.cost_table(got) == R.cost_table(ref)
    for tp in (8, 32):
        assert T.hosting_architectures(got, tp) == R.hosting_architectures(ref, tp)
        for baseline in ("nvl-72", "tpuv4"):
            assert T.cost_effectiveness_table(got, baseline=baseline, tp=tp) == \
                R.cost_effectiveness_table(ref, baseline=baseline, tp=tp)
    assert T.cost_effectiveness_table(got) == R.cost_effectiveness_table(ref)
    # dgx-h100's 8-GPU islands never host TP-32
    assert "dgx-h100" not in T.hosting_architectures(got, 32)


def test_timeline_cost_grid_and_table_match_repro():
    kw = dict(trace_nodes=24, horizon_h=20 * 24.0, tp_sizes=(8, 32), seed=5)
    archs = ("infinitehbd-k3", "nvl-72", "tpuv4", "big-switch")
    tl = t_replay_trace(TChurnSpec(**kw).trace(0), tp_sizes=(8, 32), architectures=archs,
                        backend="torch", device="cpu")
    ref = r_replay_trace(RChurnSpec(**kw).trace(0), tp_sizes=(8, 32), architectures=archs,
                         backend="numpy")
    assert np.array_equal(tl.placed_gpus, ref.placed_gpus)
    with pytest.raises(KeyError, match="no BOM"):
        T.timeline_cost_grid(tl)              # big-switch cannot be priced
    priced = [n for n in archs if n in BOM_REGISTRY]
    sub_t = t_replay_trace(TChurnSpec(**kw).trace(0), tp_sizes=(8, 32), architectures=priced,
                           backend="torch", device="cpu")
    sub_r = r_replay_trace(RChurnSpec(**kw).trace(0), tp_sizes=(8, 32), architectures=priced,
                           backend="numpy")
    for unit in (25000.0, 31337.5):
        got = T.timeline_cost_grid(sub_t, gpu_unit_cost=unit)
        assert got.shape == sub_t.placed_gpus.shape
        assert np.array_equal(got, R.timeline_cost_grid(sub_r, gpu_unit_cost=unit))
    t_model, r_model = TSimModel(**TINY), RSimModel(**TINY)
    for tp in (8, 32):
        rows = T.timeline_cost_table(tl, t_model, tp=tp, global_batch=512)
        assert rows == R.timeline_cost_table(ref, r_model, tp=tp, global_batch=512)
        assert [r["architecture"] for r in rows] == priced
    assert T.timeline_cost_table(tl, t_model, global_batch=512, gpu_unit_power_w=500.0) == \
        R.timeline_cost_table(ref, r_model, global_batch=512, gpu_unit_power_w=500.0)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_comparison_matrix_matches_repro(backend):
    kw = dict(fault_ratios=(0.0, 0.05), samples=4, seed=2)
    got = comparison_matrix(128, backend=backend, device="cpu", **kw)
    ref = r_comparison_matrix(128, backend="numpy", **kw)
    assert len(got) == 2 * 13 and got == ref
    rows = {(r["architecture"], r["fault_ratio"]): r for r in got}
    assert rows[("big-switch", 0.0)]["cross_tor_share"] is None
    assert rows[("big-switch", 0.0)]["usd_per_mfu_gpu_h"] is None
    assert rows[("infinitehbd-k3", 0.05)]["priced"]


def test_comparison_matrix_options_match_repro():
    """A subset of architectures at TP-16, a small job model, explicit
    byte weights and DCN geometry: ``repro``'s rows again."""
    kw = dict(fault_ratios=(0.02, 0.10), samples=3, tp=16, seed=7,
              architectures=("infinitehbd-k2", "tpuv4", "dgx-h100", "railx"),
              global_batch=512, max_dp=8, amortize_h=8760.0, dp_bytes=2.0,
              tp_bytes=5.0, dcn_kwargs=dict(agg_domain=32, job_scale=0.5))
    got = comparison_matrix(96, sim_model=TSimModel(**TINY), device="cpu", **kw)
    assert got == r_comparison_matrix(96, sim_model=RSimModel(**TINY), backend="numpy", **kw)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_cost_sweep(T.CostSpec(num_nodes=64, samples=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comparison_matrix(64, fault_ratios=(0.0,), samples=2)
