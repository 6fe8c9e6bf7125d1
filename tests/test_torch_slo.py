"""The port's serving-SLO engine (``repro_torch.slo``) against ``repro.slo``.

The serving scan runs with ``backend="torch", device="cpu"`` (the doubling
scan of clamp-shift maps) and ``backend="numpy"``; every grid must equal
``repro``'s numpy and jax backends and the port's event-by-event scalar
reference with ``np.array_equal``, every table ``repro``'s with ``==``.
Arrivals, timelines and the random scan drivers come from fixed seeds;
there are no hypothesis draws.  On the card ``chip_smoke.py`` holds the
scan to the port's numpy scan and to ``BENCH_serve.json``.
"""

import numpy as np
import pytest
import torch

import repro.slo as R
from repro.churn import ChurnJob as RChurnJob
from repro.churn import ChurnSpec as RChurnSpec
from repro.churn import ChurnTimeline as RTimeline
from repro.churn import ReconfigRecord as RRecord
from repro.churn import replay_trace as r_replay_trace
import repro_torch.slo as T
from repro_torch.churn import ChurnJob as TChurnJob
from repro_torch.churn import ChurnSpec as TChurnSpec
from repro_torch.churn import ChurnTimeline as TTimeline
from repro_torch.churn import ReconfigRecord as TRecord
from repro_torch.churn import replay_trace as t_replay_trace
from repro_torch.slo import torch_backend
from repro_torch.slo.engine import _scan_numpy

GRID_FIELDS = ("arrivals", "capacity", "served", "abandoned", "queue_depth", "served_cum",
               "gone_cum")


def _timeline(mod, timeline_cls, record_cls):
    """A hand-built single-TP timeline (arch-0 degrades, arch-1 collapses)
    with one reconfiguration stall, in ``mod``'s classes."""
    placed = np.array([[6, 6, 2, 2, 6, 6], [6, 0, 0, 0, 0, 6]], dtype=np.int64)
    return timeline_cls(
        horizon_h=6.0, edges_h=np.array([0.0, 1.0, 2.0, 3.5, 4.0, 5.0]),
        names=["infinitehbd-k3", "big-switch"], tp_sizes=np.array([8]),
        total_gpus=placed.max(axis=1)[:, None],
        faulty_gpus=np.zeros((2, 6, 1), np.int64), placed_gpus=placed[:, :, None],
        reconfigs=[record_cls(2.1, "fault", (1,), 0.3 * 3.6e9, 2, 8)])


def _synth_spec(mod, timeline, **kw):
    kw.setdefault("arrivals", (mod.PoissonArrivals(5.0, seed=11),
                               mod.DiurnalArrivals(4.0, seed=12, amplitude=1.0)))
    kw.setdefault("req_per_gpu_hour", 0.7)
    kw.setdefault("slo_h", 1.0)
    kw.setdefault("patience_h", 2.0)
    return mod.ServeSpec(timeline=timeline, **kw)


def _specs(**kw):
    return (_synth_spec(T, _timeline(T, TTimeline, TRecord), **kw),
            _synth_spec(R, _timeline(R, RTimeline, RRecord), **kw))


def _trace_specs():
    """A replayed Appendix-A trace with its control-plane stalls."""
    kw = dict(trace_nodes=24, horizon_h=3 * 24.0, tp_sizes=(8,), seed=3)
    archs = ("big-switch", "infinitehbd-k3", "nvl-72", "tpuv4")
    out = []
    for mod, spec_cls, job_cls, replay, extra in (
            (T, TChurnSpec, TChurnJob, t_replay_trace, dict(device="cpu", backend="torch")),
            (R, RChurnSpec, RChurnJob, r_replay_trace, dict(backend="numpy"))):
        tl = replay(spec_cls(**kw).trace(0), tp_sizes=(8,), architectures=archs,
                    job=job_cls(tp_size=8, dp_size=2, agg_domain=16), **extra)
        out.append(mod.ServeSpec(
            timeline=tl, arrivals=(mod.PoissonArrivals(30.0, seed=1),
                                   mod.DiurnalArrivals(25.0, seed=2, stream=3, amplitude=0.5)),
            req_per_gpu_hour=0.2, slo_h=1.0, patience_h=6.0))
    return out


def _assert_results_equal(got, ref):
    assert got.names == ref.names and got.arrival_labels == ref.arrival_labels
    assert (got.tp_size, got.slo_h, got.patience_h, got.horizon_h) == \
        (ref.tp_size, ref.slo_h, ref.patience_h, ref.horizon_h)
    for field in GRID_FIELDS + ("total_gpus", "edges_h", "leftover"):
        g, r = getattr(got, field), getattr(ref, field)
        assert g.dtype == r.dtype and np.array_equal(g, r), field


def test_slo_exports_what_repro_slo_exports():
    assert T.__all__ == R.__all__
    assert all(hasattr(T, name) for name in R.__all__)
    assert T.MAX_MEAN == R.MAX_MEAN and T.AMORTIZE_H == R.AMORTIZE_H
    assert T.BACKENDS == ("numpy", "torch")


# ------------------------------------------------------------- arrivals

@pytest.mark.parametrize("seed,stream,count", [(0, 0, 1), (7, 3, 257), (2**40 + 5, 9, 64)])
def test_counter_uniforms_and_poisson_counts_match_repro(seed, stream, count):
    u = T.counter_uniforms(seed, stream, count)
    assert u.dtype == np.float64 and np.array_equal(u, R.counter_uniforms(seed, stream, count))
    assert ((u > 0) & (u < 1)).all()
    means = np.random.default_rng(seed % 1000).uniform(0.0, 300.0, size=count)
    means[0] = 0.0
    got = T.poisson_counts(means, u)
    assert got.dtype == np.int64 and np.array_equal(got, R.poisson_counts(means, u))
    assert T.counter_uniforms(seed, stream, 0).shape == (0,)


def test_poisson_counts_guards():
    with pytest.raises(ValueError, match="exceeds"):
        T.poisson_counts(np.array([T.MAX_MEAN + 1.0]), np.array([0.5]))
    with pytest.raises(ValueError, match="negative"):
        T.poisson_counts(np.array([-1.0]), np.array([0.5]))
    with pytest.raises(ValueError, match="!="):
        T.poisson_counts(np.zeros(2), np.zeros(3))
    with pytest.raises(ValueError, match="amplitude"):
        T.DiurnalArrivals(3.0, amplitude=1.5)


def test_arrival_generators_match_repro():
    edges = np.array([0.0, 0.5, 3.0, 7.25, 20.0, 26.0])
    for kw in (dict(rate_per_h=17.0, seed=4, stream=2), dict(rate_per_h=0.3)):
        for t_cls, r_cls, extra in ((T.PoissonArrivals, R.PoissonArrivals, {}),
                                    (T.DiurnalArrivals, R.DiurnalArrivals,
                                     dict(amplitude=0.8, peak_h=9.0))):
            t, r = t_cls(**kw, **extra), r_cls(**kw, **extra)
            assert t.label == r.label
            assert np.array_equal(t.interval_means(edges, 30.0), r.interval_means(edges, 30.0))
            assert np.array_equal(t.counts(edges, 30.0), r.counts(edges, 30.0))


# ------------------------------------------------ deadlines and capacity

@pytest.mark.parametrize("patience", [0.0, 0.5, 2.0, 7.0])
def test_cohort_deadlines_and_expire_cumulative_match_repro(patience):
    edges = np.array([0.0, 1.0, 1.5, 2.0, 3.5, 4.0, 5.0])
    dead = T.cohort_deadlines(edges, 6.0, patience)
    assert dead.dtype == np.int64 and np.array_equal(dead, R.cohort_deadlines(edges, 6.0, patience))
    ca = np.cumsum(np.random.default_rng(3).integers(0, 9, size=(3, 7)), axis=1)
    assert np.array_equal(T.expire_cumulative(ca, dead), R.expire_cumulative(ca, dead))


def test_interval_capacity_matches_repro():
    tl_t, tl_r = _timeline(T, TTimeline, TRecord), _timeline(R, RTimeline, RRecord)
    for kw in (dict(), dict(req_per_gpu_hour=3.3), dict(reconfig_pause=False), dict(tp=8)):
        got = T.interval_capacity(tl_t, **kw)
        assert got.dtype == np.int64 and np.array_equal(got, R.interval_capacity(tl_r, **kw))
    with pytest.raises(ValueError, match="req_per_gpu_hour"):
        T.interval_capacity(tl_t, req_per_gpu_hour=-1.0)
    spec_t, spec_r = _trace_specs()
    assert np.array_equal(spec_t.capacity_matrix(), spec_r.capacity_matrix())
    assert np.array_equal(spec_t.arrival_matrix(), spec_r.arrival_matrix())


def test_spec_validation():
    tl = _timeline(T, TTimeline, TRecord)
    with pytest.raises(ValueError, match="arrival stream"):
        T.ServeSpec(timeline=tl, arrivals=())
    with pytest.raises(ValueError, match="patience_h"):
        T.ServeSpec(timeline=tl, arrivals=(T.PoissonArrivals(1.0),), patience_h=-1.0)


# ------------------------------------------------------ engine equality

@pytest.mark.parametrize("which", ["synthetic", "trace"])
def test_run_serve_sweep_matches_repro_and_scalar(which):
    spec_t, spec_r = _specs() if which == "synthetic" else _trace_specs()
    got = T.run_serve_sweep(spec_t, backend="torch", device="cpu")
    assert got.backend == "torch"
    _assert_results_equal(got, R.run_serve_sweep(spec_r, backend="numpy"))
    _assert_results_equal(got, R.run_serve_sweep(spec_r, backend="jax"))
    _assert_results_equal(got, T.run_serve_sweep(spec_t, backend="numpy"))
    scalar = T.run_serve_scalar(spec_t)
    assert scalar.backend == "scalar"
    _assert_results_equal(got, scalar)
    ref_scalar = R.run_serve_scalar(spec_r)
    assert scalar.pair_log == ref_scalar.pair_log
    for r in range(len(got.arrival_labels)):
        for a in range(len(got.names)):
            assert T.request_outcomes(got, r, a) == scalar.pair_log[(r, a)]
            assert T.request_outcomes(got, r, a) == R.request_outcomes(ref_scalar, r, a)


def _drivers(seed, R_, A, B, cap_hi=25):
    rng = np.random.default_rng(seed)
    ca = np.cumsum(rng.integers(0, 20, (R_, B)), axis=1)
    cap = rng.integers(0, cap_hi, (A, B))
    dead = np.maximum.accumulate(np.arange(B) + rng.integers(0, 6, B)) if B else \
        np.zeros(0, np.int64)
    return ca, cap, T.expire_cumulative(ca, dead)


@pytest.mark.parametrize("B", [0, 1, 2, 3, 5, 64, 129, 300])
def test_clamp_map_scan_matches_numpy_scan(B):
    ca, cap, expire = _drivers(B, 3, 4, B)
    cap[0] = 0                                   # a fleet that never serves
    cases = [(ca, cap, expire), (ca, cap, ca.copy()),         # every cohort gone at once
             (ca, np.full_like(cap, 2**40), expire)]           # budgets that never bind
    for args in cases:
        want = _scan_numpy(*args)
        got = torch_backend.serve_scan(*args, device="cpu")
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and g.shape == (3, 4, B) and np.array_equal(g, w)


@pytest.mark.parametrize("B,passes", [(1, 0), (2, 1), (5, 3), (1342, 11), (1025, 11)])
def test_clamp_map_scan_takes_log2_passes(monkeypatch, B, passes):
    """The scan composes maps in ceil(log2 B) doubling passes (two clamps
    a pass), not one step per interval."""
    calls = []
    clamp = torch_backend._clamp
    monkeypatch.setattr(torch_backend, "_clamp", lambda *a: calls.append(1) or clamp(*a))
    ca, cap, expire = _drivers(1, 2, 2, B)
    got = torch_backend.serve_scan(ca, cap, expire, device="cpu")
    assert len(calls) == 2 * passes + 1
    assert all(np.array_equal(g, w) for g, w in zip(got, _scan_numpy(ca, cap, expire)))


def test_overflow_guard_and_counters():
    with pytest.raises(OverflowError, match="2\\*\\*31"):
        torch_backend.serve_scan(np.array([[2**31]]), np.array([[1]]), np.zeros((1, 1)),
                                 device="cpu")
    ca = np.array([[2**31 - 1]])
    got = torch_backend.serve_scan(ca, np.array([[2**62]]), np.zeros((1, 1)), device="cpu")
    assert [int(g[0, 0, 0]) for g in got] == [2**31 - 1, 2**31 - 1, 2**31 - 1, 0]
    from repro_torch import obs
    was = obs.enabled()
    obs.enable()
    try:
        before = obs.summary().get("counters", {}).get("slo.torch.scans", 0)
        torch_backend.serve_scan(ca, np.array([[5]]), np.zeros((1, 1)), device="cpu")
        summary = obs.summary()
        assert summary["counters"]["slo.torch.scans"] == before + 1
        assert "slo.torch.serve_scan" in summary["spans"]
    finally:
        if not was:
            obs.disable()


def test_resolve_backend_env(monkeypatch):
    monkeypatch.delenv("REPRO_SWEEP_BACKEND", raising=False)
    assert T.resolve_backend(None) == "torch"
    assert T.resolve_backend("auto") == "torch"
    assert T.resolve_backend("numpy") == "numpy"
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "numpy")
    assert T.resolve_backend(None) == "numpy"
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "auto")
    assert T.resolve_backend("auto") == "torch"
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "bogus")
    with pytest.raises(ValueError, match="REPRO_SWEEP_BACKEND"):
        T.resolve_backend("auto")
    with pytest.raises(ValueError, match="unknown backend"):
        T.resolve_backend("jax")


# ------------------------------------------------------------ tables

@pytest.mark.parametrize("which", ["synthetic", "trace"])
def test_slo_tables_match_repro(which):
    spec_t, spec_r = _specs() if which == "synthetic" else _trace_specs()
    got = T.run_serve_sweep(spec_t, device="cpu")
    ref = R.run_serve_sweep(spec_r, backend="numpy")
    assert T.slo_table(got) == R.slo_table(ref)
    assert T.timeline_slo_table(got) == R.timeline_slo_table(ref)
    kw = dict(gpu_unit_cost=1234.5, amortize_h=1000.0)
    assert T.timeline_slo_table(got, **kw) == R.timeline_slo_table(ref, **kw)


def test_tables_of_a_fleet_that_never_serves():
    """Zero capacity with patience past the horizon: every request is
    leftover, waits are ``None``, unit costs ``None`` -- as in ``repro``."""
    spec_t, spec_r = _specs(req_per_gpu_hour=0.0, patience_h=100.0)
    got = T.run_serve_sweep(spec_t, device="cpu")
    ref = R.run_serve_sweep(spec_r, backend="numpy")
    _assert_results_equal(got, ref)
    rows = T.slo_table(got)
    assert rows == R.slo_table(ref) and all(r["p99_wait_h"] is None for r in rows)
    assert T.timeline_slo_table(got) == R.timeline_slo_table(ref)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    spec_t, _ = _specs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_serve_sweep(spec_t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_serve_sweep(spec_t, backend="auto")
