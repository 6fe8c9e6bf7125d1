"""The port's structured fault generators (``repro_torch.faults``) against
``repro.faults``.

For every generator the NumPy masks, the torch masks (``torch_masks`` on
the CPU) and ``repro``'s ``masks`` and ``jax_masks`` must be equal, and
equal to the SHA-256 pins of ``tests/test_prng_digests.py`` (copied
below); the draws, the helpers, the traces and the analytic statistics
must equal ``repro``'s.  Every draw is seeded; there are no hypothesis
draws.  On the card ``chip_smoke.py`` holds ``torch_masks`` to the NumPy
masks at ``BENCH_faults.json``'s size and at 8192 nodes.
"""

import hashlib

import numpy as np
import pytest
import torch

import repro.faults as R
from repro.core.prng import threefry_bits as r_threefry_bits
from repro.faults.jax_mirror import JaxDraw
import repro_torch.faults as T
from repro_torch.core.prng import threefry_fold_in, threefry_seed
from repro_torch.faults.base import NUMPY_OPS
from repro_torch.faults.torch_mirror import TorchDraw, TorchOps, threefry_bits_torch
from repro_torch.sim import ScenarioSpec, run_sweep, run_sweep_scalar

#: sha256 of ``masks(96)`` at samples=128, seed=7 (tests/test_prng_digests.py).
GENERATOR_PINS = [
    (T.CorrelatedTorOutages, R.CorrelatedTorOutages,
     "1b5d6d7492f36251b5b74fc5c28314923c1315712bef9397aad0ce50ce6fc8f1"),
    (T.MaintenanceWindows, R.MaintenanceWindows,
     "9132aeddd11588340bd237006d72476862d2394563e6e74da38db2769c88b559"),
    (T.BurstStorms, R.BurstStorms,
     "1f2b1b812691d3c4d608118b12c1c90a7595ecf8553be482a51893416f39ee68"),
    (T.FlappingStragglers, R.FlappingStragglers,
     "02d35517fedde8056c774457b9a418645b17d589e7f81b06b24187adca339834"),
]
PAIRS = [(t, r) for t, r, _ in GENERATOR_PINS]
CPU = TorchOps("cpu")


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_faults_export_what_repro_faults_exports():
    assert T.__all__ == R.__all__
    assert all(hasattr(T, name) for name in R.__all__)
    assert [g.__name__ for g in T.GENERATORS] == [g.__name__ for g in R.GENERATORS]


@pytest.mark.parametrize("t_cls,r_cls,digest", GENERATOR_PINS)
def test_masks_match_repro_and_the_pinned_digests(t_cls, r_cls, digest):
    gen, ref = t_cls(samples=128, seed=7), r_cls(samples=128, seed=7)
    host = gen.masks(96)
    dev = gen.torch_masks(96, device="cpu")
    assert dev.dtype == torch.bool and dev.device.type == "cpu" and dev.shape == (128, 96)
    assert host.dtype == np.bool_
    for other in (dev.numpy(), ref.masks(96), np.asarray(ref.jax_masks(96))):
        assert np.array_equal(host, other)
    assert _sha(host) == _sha(dev.numpy()) == digest


@pytest.mark.parametrize("t_cls,r_cls", PAIRS)
@pytest.mark.parametrize("nodes,kw", [(1, {}), (37, dict(tick_h=0.5)), (200, dict(seed=3)),
                                      (8, dict(samples=12, seed=2))])
def test_masks_match_repro_at_other_sizes(t_cls, r_cls, nodes, kw):
    kw = {"samples": 48, "seed": 11, **kw}
    gen, ref = t_cls(**kw), r_cls(**kw)
    want = ref.masks(nodes)
    assert np.array_equal(gen.masks(nodes), want)
    assert np.array_equal(gen.torch_masks(nodes, device="cpu").numpy(), want)


@pytest.mark.parametrize("t_cls,r_cls,kw", [
    (T.CorrelatedTorOutages, R.CorrelatedTorOutages,
     dict(domain_nodes=7, event_p=1.0, node_event_p=0.0, dur_min_ticks=1, dur_max_ticks=40)),
    (T.CorrelatedTorOutages, R.CorrelatedTorOutages,
     dict(domain_nodes=16, events_per_domain=1, event_p=0.0, node_events=5)),
    (T.BurstStorms, R.BurstStorms,
     dict(max_storms=3, gap_continue_p=0.0, hit_p=1.0, decay_continue_p=1.0,
          decay_cap_ticks=2, gap_cap_ticks=2)),
    (T.FlappingStragglers, R.FlappingStragglers, dict(flap_p=1.0, up_ticks=2, down_ticks=3)),
    (T.MaintenanceWindows, R.MaintenanceWindows,
     dict(domain_nodes=5, period_ticks=7, window_ticks=7)),
])
def test_masks_match_repro_with_degenerate_parameters(t_cls, r_cls, kw):
    gen, ref = t_cls(samples=40, seed=4, **kw), r_cls(samples=40, seed=4, **kw)
    want = ref.masks(64)
    assert np.array_equal(gen.masks(64), want)
    assert np.array_equal(gen.torch_masks(64, device="cpu").numpy(), want)


def test_maintenance_schedule_before_its_phase():
    """``rel = t - phase`` is negative before the phase: numpy floors its
    ``%`` and ``//``, and the torch ops must too."""
    kw = dict(samples=200, seed=5, period_ticks=48, window_ticks=6, domain_nodes=8)
    gen, ref = T.MaintenanceWindows(**kw), R.MaintenanceWindows(**kw)
    in_window, dom_t = gen._schedule(12, NUMPY_OPS, T.NumpyDraw(5))
    t_in, t_dom = gen._schedule(12, CPU, TorchDraw(5, "cpu"))
    phase = int(np.argmax(in_window))
    assert phase >= kw["window_ticks"]           # the first ticks lie before it
    assert not in_window[:phase].any() and (dom_t[:phase] == dom_t[phase]).all()
    assert np.array_equal(t_in.numpy(), in_window) and np.array_equal(t_dom.numpy(), dom_t)
    want = ref.masks(96)
    assert np.array_equal(gen.masks(96), want)
    assert np.array_equal(gen.torch_masks(96, device="cpu").numpy(), want)
    assert not want[:phase].any()
    assert gen.expected_fault_ratio(96) == ref.expected_fault_ratio(96)


@pytest.mark.parametrize("size", [0, 1, 2, 3, 17, 1000, 1001])
def test_threefry_bits_torch_matches_the_original_layout(size):
    key = threefry_fold_in(threefry_seed(9), 4)
    got = threefry_bits_torch(key, size, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (size,)
    assert np.array_equal(got.numpy(), r_threefry_bits(key, size).astype(np.int64))


@pytest.mark.parametrize("shape", [5, (3, 4), (2, 3, 5), (0, 7)])
def test_draws_match_repro(shape):
    got = TorchDraw(13, "cpu").bits(6, shape).numpy()
    want = R.NumpyDraw(13).bits(6, shape)
    assert np.array_equal(T.NumpyDraw(13).bits(6, shape), want)
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(got, np.asarray(JaxDraw(13).bits(6, shape)).astype(np.int64))


@pytest.mark.parametrize("ops", [NUMPY_OPS, CPU], ids=["numpy", "torch"])
def test_helpers_match_repro(ops):
    draw = T.NumpyDraw(21) if ops is NUMPY_OPS else TorchDraw(21, "cpu")
    ref = R.NumpyDraw(21)

    def host(x):
        return np.asarray(x) if ops is NUMPY_OPS else x.numpy()

    for ratio in (0.0, 1e-12, 0.3, 1.0):
        got = host(T.bernoulli(draw.bits(1, (6, 9)), ratio, ops))
        assert np.array_equal(got, R.bernoulli(ref.bits(1, (6, 9)), ratio, np))
    for n in (1, 7, 2**31 - 1):
        got = host(T.uniform_int(draw.bits(2, (40,)), n, ops))
        assert np.array_equal(got, R.uniform_int(ref.bits(2, (40,)), n, np))
        assert got.dtype == np.int32
    for p in (0.0, 0.6, 1.0):
        got = host(T.trunc_geometric(draw.bits(3, (5, 8, 11)), p, ops))
        assert np.array_equal(got, R.trunc_geometric(ref.bits(3, (5, 8, 11)), p, np))
    starts = R.uniform_int(ref.bits(4, (6, 3)), 30, np)
    durs = 1 + R.uniform_int(ref.bits(5, (6, 3)), 30, np)
    active = R.bernoulli(ref.bits(6, (6, 3)), 0.5, np)
    if ops is CPU:
        args = [torch.from_numpy(a) for a in (starts, durs, active)]
    else:
        args = [starts, durs, active]
    got = host(T.wrap_occupancy(ops, 30, *args))
    assert np.array_equal(got, R.wrap_occupancy(np, 30, starts, durs, active))
    for p, m in ((0.0, 3), (0.6, 10), (1.0, 4)):
        assert T.trunc_geometric_mean(p, m) == R.trunc_geometric_mean(p, m)


@pytest.mark.parametrize("t_cls,r_cls", PAIRS)
def test_traces_round_trip_and_match_repro(t_cls, r_cls):
    gen, ref = t_cls(samples=60, tick_h=0.5, seed=3), r_cls(samples=60, tick_h=0.5, seed=3)
    masks = gen.masks(40)
    trace = gen.trace(40)
    assert trace.num_nodes == 40 and trace.horizon_h == gen.horizon_h == ref.horizon_h
    assert np.array_equal(trace.fault_masks(gen.sample_times()), masks)
    assert np.array_equal(gen.sample_times(), ref.sample_times())
    want = ref.trace(40)
    assert [(e.node, e.start_h, e.end_h) for e in trace.events] == \
        [(e.node, e.start_h, e.end_h) for e in want.events]


def test_masks_to_trace_edges():
    empty = T.masks_to_trace(np.zeros((4, 3), dtype=bool), 1.0)
    assert empty.events == [] and empty.horizon_h == 4.0
    m = np.zeros((4, 2), dtype=bool)
    m[2:, 1] = True                      # run [2, 4) on node 1
    m[0, 0] = True
    tr = T.masks_to_trace(m, 2.0)
    ref = R.masks_to_trace(m, 2.0)
    assert [(e.node, e.start_h, e.end_h) for e in tr.events] == \
        [(e.node, e.start_h, e.end_h) for e in ref.events] == [(0, 0.0, 2.0), (1, 4.0, 8.0)]
    assert tr.horizon_h == 8.0


def test_analytic_statistics_match_repro():
    kw = dict(samples=96, seed=2)
    tor = dict(domain_nodes=6, events_per_domain=3, event_p=0.4, dur_min_ticks=3,
               dur_max_ticks=9, node_events=4, node_event_p=0.2)
    t, r = T.CorrelatedTorOutages(**kw, **tor), R.CorrelatedTorOutages(**kw, **tor)
    for name in ("domain_down_p", "node_background_p", "expected_intra_domain_correlation"):
        assert getattr(t, name)() == getattr(r, name)()
    for n in (5, 64, 100):
        assert t.expected_fault_ratio(n) == r.expected_fault_ratio(n)
    t, r = T.MaintenanceWindows(**kw), R.MaintenanceWindows(**kw)
    for n in (4, 64, 100):
        assert t.expected_fault_ratio(n) == r.expected_fault_ratio(n)
    t, r = T.BurstStorms(**kw), R.BurstStorms(**kw)
    assert t.expected_gap_ticks() == r.expected_gap_ticks()
    assert t.expected_duration_ticks() == r.expected_duration_ticks()
    assert np.array_equal(t.storm_gaps(), r.storm_gaps())
    assert np.array_equal(t.storm_starts(), r.storm_starts())
    for got, want in zip(t.hit_durations(50), r.hit_durations(50)):
        assert np.array_equal(got, want)
    t, r = T.FlappingStragglers(**kw, flap_p=0.3), R.FlappingStragglers(**kw, flap_p=0.3)
    assert t.flappers(80) == r.flappers(80) and t.cycle_ticks == r.cycle_ticks
    assert t.expected_fault_ratio(80) == r.expected_fault_ratio(80)


def test_straggler_schedule_matches_repro():
    kw = dict(samples=12, seed=8, flap_p=0.25, up_ticks=2, down_ticks=1, slow_factor=3.0)
    t, r = T.FlappingStragglers(**kw), R.FlappingStragglers(**kw)
    for steps, base in ((30, 1.0), (5, 0.25)):
        assert t.straggler_schedule(24, steps, base) == r.straggler_schedule(24, steps, base)


def test_constructor_guards_match_repro():
    for kw in (dict(samples=0), dict(samples=4, tick_h=0.0)):
        with pytest.raises(ValueError):
            T.StructuredScenario(**kw)
    bad = [(T.CorrelatedTorOutages, dict(domain_nodes=0)),
           (T.CorrelatedTorOutages, dict(dur_min_ticks=5, dur_max_ticks=4)),
           (T.MaintenanceWindows, dict(window_ticks=30)),
           (T.BurstStorms, dict(max_storms=0)), (T.BurstStorms, dict(gap_cap_ticks=1)),
           (T.FlappingStragglers, dict(up_ticks=0)), (T.FlappingStragglers, dict(slow_factor=1.0))]
    for cls, kw in bad:
        with pytest.raises(ValueError):
            cls(samples=24, **kw)


@pytest.mark.parametrize("t_cls,r_cls", PAIRS)
def test_generators_drive_the_port_sweep(t_cls, r_cls):
    """A generator is a Snapshots source of the port's scenario engine:
    torch on the CPU equals the scalar loop and ``repro``'s masks."""
    gen = t_cls(samples=12, seed=5)
    spec = ScenarioSpec(num_nodes=64, snapshots=gen, tp_sizes=(16, 32),
                        architectures=("big-switch", "infinitehbd-k3", "acos"))
    res = run_sweep(spec, backend="torch", device="cpu")
    ref = run_sweep_scalar(spec, masks=r_cls(samples=12, seed=5).masks(64))
    assert res.backend == "torch"
    assert np.array_equal(res.placed_gpus, ref.placed_gpus)
    assert np.array_equal(res.faulty_gpus, ref.faulty_gpus)


def test_torch_masks_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for cls in T.GENERATORS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(samples=16).torch_masks(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDraw(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        threefry_bits_torch(threefry_seed(0), 4)
