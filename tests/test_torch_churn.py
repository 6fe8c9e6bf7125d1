"""The port's churn replays (``repro_torch.churn``) against ``repro.churn``.

The waste replays run through the port's scenario engine with
``backend="torch", device="cpu"`` (and ``backend="numpy"``), the traffic
replay through the port's DCN engine, the control-plane replay through the
port's ``ClusterManager``; every timeline, record and table must equal
``repro``'s on the same traces -- its ``numpy`` and ``jax`` backends and
its scalar engine.  Traces come from the Appendix-A generator at fixed
seeds; there are no hypothesis draws.  On the card ``chip_smoke.py`` holds
the same replays to the port's numpy backend at the benchmarks' sizes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.churn as R
from repro.core.control_plane import ControlPlaneConfig as RConfig
from repro.core.mfu_sim import SimModel as RSimModel
import repro_torch.churn as T
from repro_torch.core.control_plane import ControlPlaneConfig as TConfig
from repro_torch.core.mfu_sim import SimModel as TSimModel

ARCHES = ("big-switch", "infinitehbd-k2", "infinitehbd-k3", "nvl-36", "nvl-72", "tpuv4",
          "sip-ring", "dgx-h100")
SPEC = dict(trace_nodes=24, horizon_h=20 * 24.0, tp_sizes=(16, 32), architectures=ARCHES,
            seed=3)
T_SPEC, R_SPEC = T.ChurnSpec(**SPEC), R.ChurnSpec(**SPEC)
TINY = dict(name="tiny", layers=8, hidden=1024, ffn=4096, vocab=32000, heads=16, seq=2048)


def _assert_timelines_equal(got, ref):
    assert got.names == ref.names and got.horizon_h == ref.horizon_h
    for field in ("edges_h", "tp_sizes", "total_gpus", "faulty_gpus", "placed_gpus"):
        g, r = getattr(got, field), getattr(ref, field)
        assert g.dtype == r.dtype and np.array_equal(g, r), field
    assert [dataclasses.astuple(x) for x in got.reconfigs] == \
        [dataclasses.astuple(x) for x in ref.reconfigs]


def test_churn_exports_what_repro_churn_exports():
    assert T.__all__ == R.__all__
    assert all(hasattr(T, name) for name in R.__all__)


def test_traces_match_repro():
    for r in (0, 1):
        a, b = T_SPEC.trace(r), R_SPEC.trace(r)
        assert a.num_nodes == b.num_nodes == T_SPEC.num_nodes == 48
        assert np.array_equal(a.interval_edges(), b.interval_edges())
        assert a.event_deltas() == b.event_deltas()


@pytest.mark.parametrize("engine,backend", [("batched", "torch"), ("batched", "numpy"),
                                            ("scalar", "numpy")])
def test_replay_trace_matches_repro(engine, backend):
    tr_t, tr_r = T_SPEC.trace(0), R_SPEC.trace(0)
    ref = R.replay_trace(tr_r, tp_sizes=SPEC["tp_sizes"], architectures=ARCHES,
                         backend="numpy")
    got = T.replay_trace(tr_t, tp_sizes=SPEC["tp_sizes"], architectures=ARCHES,
                         engine=engine, backend=backend, device="cpu", chunk_snapshots=13)
    assert got.backend == ("scalar" if engine == "scalar" else backend)
    _assert_timelines_equal(got, ref)
    if engine == "batched" and backend == "torch":
        ref_jax = R.replay_trace(tr_r, tp_sizes=SPEC["tp_sizes"], architectures=ARCHES,
                                 backend="jax", chunk_snapshots=13)
        _assert_timelines_equal(got, ref_jax)


def test_replay_trace_with_control_plane_and_tables():
    """A replay with the job attached: the reconfiguration log, the
    interval stalls and the waste, latency and MFU tables equal ``repro``'s."""
    archs = ("big-switch", "infinitehbd-k3", "sip-ring", "dgx-h100")
    kw = dict(tp_sizes=(16,), architectures=archs, max_events=25)
    got = T.replay_trace(T_SPEC.trace(1), backend="torch", device="cpu",
                         job=T.ChurnJob(tp_size=16, dp_size=4, agg_domain=16), **kw)
    ref = R.replay_trace(R_SPEC.trace(1), backend="numpy",
                         job=R.ChurnJob(tp_size=16, dp_size=4, agg_domain=16), **kw)
    _assert_timelines_equal(got, ref)
    assert got.reconfigs
    for fn in ("durations_h", "healthy_gpus", "wasted_gpus", "waste_ratio"):
        assert np.array_equal(getattr(got, fn), getattr(ref, fn)), fn
    for fn in ("integrated_waste_ratio", "goodput_gpu_hours", "wasted_gpu_hours",
               "placed_share", "reconfig_stall_h"):
        assert np.array_equal(getattr(got, fn)(), getattr(ref, fn)()), fn
    assert T.integrated_waste_table(got) == R.integrated_waste_table(ref)
    assert T.latency_table({"a": got.reconfigs, "none": []}) == \
        R.latency_table({"a": ref.reconfigs, "none": []})
    t_model, r_model = TSimModel(**TINY), RSimModel(**TINY)
    assert T.timeline_mfu_table(got, t_model, tp=16, global_batch=512) == \
        R.timeline_mfu_table(ref, r_model, tp=16, global_batch=512)
    assert got.index("sip-ring") == 2 and got.tp_index(16) == 0


@pytest.mark.parametrize("engine", ["batched", "streamed", "scalar"])
def test_monte_carlo_replay_matches_repro(engine):
    ref = R.monte_carlo_replay(R_SPEC, 3, backend="numpy")
    got = T.monte_carlo_replay(T_SPEC, 3, engine=engine, backend="torch", device="cpu",
                               chunk_snapshots=17)
    assert got.num_traces == 3
    assert got.backend == ("scalar" if engine == "scalar" else "torch")
    for a, b in zip(got.timelines, ref.timelines):
        _assert_timelines_equal(a, b)
    assert np.array_equal(got.integrated_waste(), ref.integrated_waste())
    assert np.array_equal(got.placed_share(), ref.placed_share())
    assert got.summary_table() == ref.summary_table()
    if engine != "scalar":
        ref_jax = R.monte_carlo_replay(R_SPEC, 3, engine=engine, backend="jax",
                                       chunk_snapshots=17)
        for a, b in zip(got.timelines, ref_jax.timelines):
            _assert_timelines_equal(a, b)
        numpy = T.monte_carlo_replay(T_SPEC, [T_SPEC.trace(r) for r in range(3)],
                                     engine=engine, backend="numpy")
        for a, b in zip(numpy.timelines, ref.timelines):
            _assert_timelines_equal(a, b)


def test_monte_carlo_edges():
    for engine in ("batched", "streamed"):
        empty = T.monte_carlo_replay(T_SPEC, 0, engine=engine, backend="torch", device="cpu")
        assert empty.num_traces == 0 and empty.summary_table() == []
        assert empty.integrated_waste().shape == (0, len(ARCHES), 2)
    with pytest.raises(ValueError, match="unknown engine"):
        T.monte_carlo_replay(T_SPEC, 1, engine="bogus")
    with pytest.raises(ValueError, match="unknown engine"):
        T.replay_trace(T_SPEC.trace(0), engine="bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.monte_carlo_replay(T_SPEC, 1, backend="torch")


@pytest.mark.parametrize("config", [None, dict(protocol_delay_us=100.0,
                                               reconfig_latency_us=(42.0, 42.0))])
def test_control_plane_replay_matches_repro(config):
    kw = dict(trace_nodes=24, horizon_h=15 * 24.0, seed=5)
    jobs = (T.ChurnJob(tp_size=16, dp_size=4), R.ChurnJob(tp_size=16, dp_size=4))
    cfgs = (None, None) if config is None else (TConfig(**config), RConfig(**config))
    got = T.control_plane_replay(T.ChurnSpec(**kw).trace(0), jobs[0], config=cfgs[0],
                                 max_events=30)
    ref = R.control_plane_replay(R.ChurnSpec(**kw).trace(0), jobs[1], config=cfgs[1],
                                 max_events=30)
    assert got and [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in ref]
    # a TP group of 32 of the 48 nodes: some edges leave no feasible plan
    big = dict(tp_size=128, dp_size=2, agg_domain=16, k=1)
    got = T.control_plane_replay(T.ChurnSpec(**kw).trace(0), T.ChurnJob(**big), max_events=12)
    ref = R.control_plane_replay(R.ChurnSpec(**kw).trace(0), R.ChurnJob(**big), max_events=12)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in ref]
    assert {r.latency_us is None for r in got} == {True, False}
    assert T.latency_table({"big": got}) == R.latency_table({"big": ref})


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_traffic_replay_matches_repro(backend):
    """A 4-GPU trace on 128 nodes whose domains tile the cluster (the
    placement kernel runs, not the scalar fallback), all three variants."""
    from repro.core.trace import generate_trace as r_gen, to_4gpu_trace as r_4
    from repro_torch.core.trace import generate_trace as t_gen, to_4gpu_trace as t_4

    tr_t = t_4(t_gen(64, horizon_h=15 * 24.0, seed=4))
    tr_r = r_4(r_gen(64, horizon_h=15 * 24.0, seed=4))
    kw = dict(tp_sizes=(16, 32), job_scale=0.6, agg_domain=32, chunk_snapshots=7)
    got = T.traffic_replay(tr_t, backend=backend, device="cpu", **kw)
    refs = [R.traffic_replay(tr_r, backend=b, **kw) for b in ("numpy", "jax")]
    assert got.backend == backend
    for ref in refs:
        assert got.variants == ref.variants
        for field in ("edges_h", "tp_sizes", "groups", "dp_pairs", "crossing_pairs",
                      "crossing_pod_pairs", "feasible"):
            g, r = getattr(got, field), getattr(ref, field)
            assert g.dtype == r.dtype and np.array_equal(g, r), field
    ref = refs[0]
    assert (got.crossing_pairs[got.index("orchestrated")] > 0).any()
    for fn in ("durations_h", "crossing_gpu_hours", "dp_gpu_hours", "feasible_time_share"):
        val = getattr(got, fn)
        assert np.array_equal(val if isinstance(val, np.ndarray) else val(),
                              getattr(ref, fn) if fn == "durations_h" else getattr(ref, fn)())
    for key, val in got.time_mean_shares().items():
        assert np.array_equal(val, ref.time_mean_shares()[key]), key
    assert T.integrated_traffic_table(got) == R.integrated_traffic_table(ref)
    assert T.integrated_traffic_table(got, dp_bytes=1.0, tp_bytes=9.0) == \
        R.integrated_traffic_table(ref, dp_bytes=1.0, tp_bytes=9.0)


def test_mfu_bridge_matches_repro():
    assert T.pow2_floor(0) == R.pow2_floor(0) == 0 and T.pow2_floor(5) == 4
    xs = np.array([0, 1, 2, 3, 1024, 1500])
    assert np.array_equal(T.pow2_floor(xs), R.pow2_floor(xs))
    t_model, r_model = TSimModel(**TINY), RSimModel(**TINY)
    for dp in (0, 1, 4, 16):
        a = T.elastic_mfu(t_model, 16, dp, global_batch=512)
        b = R.elastic_mfu(r_model, 16, dp, global_batch=512)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.mfu == b.mfu and a.step_time_s == b.step_time_s
