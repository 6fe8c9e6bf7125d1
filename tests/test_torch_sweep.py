"""The port's sweep engine (``repro_torch.sim``) against ``repro.sim``.

``run_sweep(backend="torch", device="cpu")`` runs the port's torch kernels
(the InfiniteHBD one through the prefix-scan wrapper's plain version) and
must give int64 grids bit-equal to ``repro``'s ``run_sweep(backend="numpy")``
for every registered architecture, snapshot source, TP size, chunking and
mask edge case; the tables built on those grids must equal ``repro``'s.
On the card ``chip_smoke.py`` holds the same kernels, with the CUDA scan,
to the port's numpy backend.
"""

import numpy as np
import pytest
import torch

import repro.sim as R
from repro.core import arch as rarch
from repro.sim.jax_backend import MaskGen as JaxMaskGen, counter_masks_device
import repro_torch.sim as T
from repro_torch.core import arch as tarch
from repro_torch.sim.engine import evaluate_mask_stream
from repro_torch.core.prng import counter_fault_masks_torch
from repro_torch.sim import torch_backend

ARCHS = tarch.names()
TPS = (16, 32, 64, 24)


def _specs(num_nodes, source, archs, tps=TPS):
    """The same scenario in both packages; ``source`` is (kind, kwargs)."""
    kind, kw = source
    return (T.ScenarioSpec(num_nodes=num_nodes, snapshots=getattr(T, kind)(**kw),
                           tp_sizes=tps, architectures=archs),
            R.ScenarioSpec(num_nodes=num_nodes, snapshots=getattr(R, kind)(**kw),
                           tp_sizes=tps, architectures=archs))


def _assert_grids_equal(got, ref):
    assert got.names == ref.names
    for field in ("total_gpus", "faulty_gpus", "placed_gpus"):
        g, r = getattr(got, field), getattr(ref, field)
        assert g.dtype == r.dtype == np.int64, field
        assert np.array_equal(g, r), field
    assert np.array_equal(got.tp_sizes, ref.tp_sizes)


SOURCES = {
    "iid": ("IIDSnapshots", dict(fault_ratio=0.09, samples=12, seed=3)),
    "counter": ("CounterIIDSnapshots", dict(fault_ratio=0.07, samples=12, seed=0)),
    "trace": ("TraceSnapshots", dict(trace_nodes=70, samples=12, seed=2)),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_matches_repro_numpy(arch, source):
    tspec, rspec = _specs(150, SOURCES[source], (arch,))
    ref = R.run_sweep(rspec, backend="numpy")
    for chunk in (1, 1000):                        # one row a block; one block
        got = T.run_sweep(tspec, backend="torch", device="cpu", chunk_snapshots=chunk)
        assert got.backend == "torch"
        _assert_grids_equal(got, ref)
    _assert_grids_equal(T.run_sweep(tspec, backend="numpy"), ref)


def _edge_masks(width):
    rng = np.random.default_rng(width)
    rows = [np.zeros(width, bool), np.ones(width, bool),
            np.arange(width) < width - 2,             # a tail sliver healthy
            np.arange(width) >= 2,                    # a head sliver healthy
            (np.arange(width) % 3) != 0]              # gaps of two faults
    rows += list(rng.random((4, width)) < 0.3)
    return np.stack(rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_edge_masks_and_width_clipping(arch):
    """All-healthy and all-faulty rows, slivers, and masks narrower and
    wider than the cluster (``_clip_masks``: missing columns read healthy)."""
    tspec = T.ScenarioSpec(num_nodes=100, snapshots=None, tp_sizes=TPS + (4, 8),
                           architectures=(arch,))
    rspec = R.ScenarioSpec(num_nodes=100, snapshots=None, tp_sizes=TPS + (4, 8),
                           architectures=(arch,))
    for width in (60, 100, 140):
        masks = _edge_masks(width)
        _assert_grids_equal(T.run_sweep(tspec, masks=masks, backend="torch", device="cpu",
                                        chunk_snapshots=4),
                            R.run_sweep(rspec, masks=masks, backend="numpy"))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_empty_sweep(backend):
    tspec, rspec = _specs(64, ("IIDSnapshots", dict(fault_ratio=0.1, samples=0)), ARCHS)
    got = T.run_sweep(tspec, backend=backend, device="cpu")
    assert got.placed_gpus.shape == (len(ARCHS), 0, len(TPS))
    _assert_grids_equal(got, R.run_sweep(rspec, backend="numpy"))


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_streamed_path_matches_batched(chunk):
    """``evaluate_mask_stream`` re-chunks ragged source chunks and equals
    one ``evaluate_masks`` call of ``repro`` on the concatenation."""
    masks = np.random.default_rng(chunk).random((37, 130)) < 0.12
    models = T.ScenarioSpec(num_nodes=130, snapshots=None, architectures=ARCHS).models()
    rmodels = R.ScenarioSpec(num_nodes=130, snapshots=None, architectures=ARCHS).models()
    pieces = np.split(masks, [3, 4, 20, 20, 31])
    seen = []
    total, faulty, placed, chosen = evaluate_mask_stream(
        models, TPS, iter(pieces), masks.shape[0], chunk_snapshots=chunk,
        backend="torch", device="cpu", progress=seen.append)
    assert chosen == "torch" and seen[-1].units_done == masks.shape[0]
    want = R.evaluate_masks(rmodels, TPS, masks, backend="numpy")
    for g, w in zip((total, faulty, placed), want[:3]):
        assert np.array_equal(g, w)
    batched = T.evaluate_masks(models, TPS, masks, chunk_snapshots=chunk,
                               backend="torch", device="cpu")
    for g, w in zip(batched[:3], want[:3]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("chunk", [1, 7, 100])
def test_counter_spec_draws_on_device_chunk_invariant(chunk):
    tspec, rspec = _specs(210, ("CounterIIDSnapshots",
                                dict(fault_ratio=0.09, samples=37, seed=6)),
                          ARCHS, tps=(16, 32, 48))
    _assert_grids_equal(T.run_sweep(tspec, backend="torch", device="cpu",
                                    chunk_snapshots=chunk),
                        R.run_sweep(rspec, backend="numpy"))


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


@pytest.mark.parametrize("ratio,seed", [(0.07, 0), (0.5, 11), (0.0, 3), (1.0, 5)])
def test_counter_masks_match_jax_device_draw(canonical_jax_draws, ratio, seed):
    want = counter_masks_device(JaxMaskGen(samples=13, num_nodes=97, fault_ratio=ratio,
                                           seed=seed))
    got = counter_fault_masks_torch(97, ratio, 13, seed, device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_tpuv4_places_432_of_384_at_tp24():
    """The reference over-places at TPs that do not divide a cube (ROADMAP
    § 3); the port reproduces it bit-for-bit."""
    masks = np.zeros((1, 96), bool)
    tspec = T.ScenarioSpec(num_nodes=96, snapshots=None, tp_sizes=(24, 32),
                           architectures=("tpuv4",))
    got = T.run_sweep(tspec, masks=masks, backend="torch", device="cpu")
    assert got.total_gpus.tolist() == [[384, 384]]
    assert got.placed_gpus.tolist() == [[[432, 384]]]
    ref = R.run_sweep(R.ScenarioSpec(num_nodes=96, snapshots=None, tp_sizes=(24, 32),
                                     architectures=("tpuv4",)), masks=masks, backend="numpy")
    _assert_grids_equal(got, ref)


@pytest.fixture(scope="module")
def trace_results():
    tspec, rspec = _specs(240, ("TraceSnapshots", dict(trace_nodes=130, samples=60, seed=2)),
                          T.DEFAULT_ARCHITECTURES, tps=(16, 32, 64))
    return (T.run_sweep(tspec, backend="torch", device="cpu"),
            R.run_sweep(rspec, backend="numpy"))


@pytest.mark.parametrize("table", ["waste_table", "max_job_table", "fault_waiting_table"])
def test_tables_equal_repro(trace_results, table):
    got, ref = trace_results
    args = ((64, 256, 900),) if table == "fault_waiting_table" else ()
    rows = getattr(T, table)(got, *args)
    assert rows == getattr(R, table)(ref, *args)
    assert T.to_csv(rows) == R.to_csv(rows)


def test_scalar_reference_equals_torch(trace_results):
    got, _ = trace_results
    _assert_grids_equal(T.run_sweep_scalar(got.spec), got)


def test_registry_names_and_order():
    assert tarch.names() == rarch.names()
    assert len(tarch.names()) == 13
    assert T.DEFAULT_ARCHITECTURES == R.DEFAULT_ARCHITECTURES
    assert list(T.MODEL_REGISTRY) == list(R.MODEL_REGISTRY)
    for name in tarch.names():
        t, r = tarch.get(name), rarch.get(name)
        assert (t.priced, t.placement_variant, t.default_sweep, t.paper) == \
            (r.priced, r.placement_variant, r.default_sweep, r.paper)
        assert t.bom == r.bom or (t.bom.name, t.bom.per_gpu_cost) == \
            (r.bom.name, r.bom.per_gpu_cost)
        model = tarch.make_model(name, 64)
        assert model.static_key() == rarch.make_model(name, 64).static_key()
        assert torch_backend.available_for([model])
    assert any("torch_kernel" in field for field, _ in tarch.CONTRACT)
    with pytest.raises(KeyError, match="torch_kernel"):
        tarch.get("no-such-arch")


def test_resolve_backend_explicit_and_env(monkeypatch):
    models = T.ScenarioSpec(num_nodes=32, snapshots=None, tp_sizes=(16,)).models()
    monkeypatch.delenv("REPRO_SWEEP_BACKEND", raising=False)
    assert T.resolve_backend("auto", models) == "torch"
    assert T.resolve_backend(None, models) == "torch"
    assert T.resolve_backend("numpy", models) == "numpy"
    assert T.resolve_backend("torch", models) == "torch"
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "numpy")
    assert T.resolve_backend("auto", models) == "numpy"
    assert T.resolve_backend("torch", models) == "torch"     # explicit wins
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "torch")
    assert T.resolve_backend("auto", models) == "torch"
    monkeypatch.setenv("REPRO_SWEEP_BACKEND", "jax")
    with pytest.raises(ValueError):
        T.resolve_backend("auto", models)
    with pytest.raises(ValueError):
        T.resolve_backend("jax", models)


def test_model_without_torch_kernel():
    from repro_torch.core.hbd_models import HBDModel

    class WeirdModel(HBDModel):
        name = "weird"

    models = [WeirdModel(16, 4)]
    assert not torch_backend.available_for(models)
    assert T.resolve_backend("auto", models) == "numpy"     # per-call fallback
    with pytest.raises(RuntimeError, match="weird"):
        T.resolve_backend("torch", models)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tspec, _ = _specs(64, SOURCES["counter"], ("infinitehbd-k3",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_sweep(tspec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_sweep(tspec, masks=np.zeros((2, 64), bool), backend="torch")
    assert T.run_sweep(tspec, backend="numpy").backend == "numpy"
