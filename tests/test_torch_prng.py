"""The port's threefry streams against ``repro.core.prng`` and ``jax.random``.

The torch draw (int64 lanes masked to 32 bits) must give the raw cipher,
``fold_in``, the bit layouts and the fault masks of the NumPy mirror
bit-for-bit, and the NumPy copy in the port must stay the mirror it was
copied from.  The SHA-256 pins of ``tests/test_prng_digests.py`` hold all
of them to the published streams.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prng as rprng
from repro_torch.core import prng as tprng
from test_prng_digests import IID_PINS


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int64 and int(t.min()) >= 0 and int(t.max()) < 1 << 32
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("k0,k1", [(0, 0), (0, 42), (0xFFFFFFFF, 0x12345678),
                                   (2**31, 7)])
def test_threefry2x32_matches_numpy(k0, k1):
    rng = np.random.default_rng(k1)
    c0 = rng.integers(0, 1 << 32, 257, dtype=np.uint32)
    c1 = rng.integers(0, 1 << 32, 257, dtype=np.uint32)
    want = rprng.threefry2x32(k0, k1, c0, c1)
    got = tprng.threefry2x32_torch(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                                   torch.from_numpy(c1.astype(np.int64)))
    for w, g in zip(want, got):
        assert np.array_equal(_u32(g), w)
    assert np.array_equal(tprng.threefry2x32(k0, k1, c0, c1)[0], want[0])


@pytest.mark.parametrize("seed", [0, 5, 123, 2**32 - 1])
def test_fold_in_matches_jax_random(seed):
    data = np.array([0, 1, 42, 4095, 2**31 - 1], dtype=np.int64)
    k0, k1 = tprng.threefry_fold_in_torch(seed, torch.from_numpy(data))
    key = jax.random.PRNGKey(seed, impl="threefry2x32")
    assert np.array_equal(np.asarray(jax.random.key_data(key)), tprng.threefry_seed(seed))
    for i, d in enumerate(data):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, int(d))))
        assert np.array_equal(np.array([int(k0[i]), int(k1[i])], np.uint32), want)
        assert np.array_equal(tprng.threefry_fold_in(tprng.threefry_seed(seed), int(d)), want)
    assert np.array_equal(
        np.stack([_u32(k0), _u32(k1)], -1),
        rprng.threefry_fold_in_batch(rprng.threefry_seed(seed), data))


@pytest.mark.parametrize("n", [1, 6, 7, 720, 1001])
@pytest.mark.parametrize("partitionable", [False, True])
def test_threefry_bits_both_layouts(n, partitionable):
    key = rprng.threefry_fold_in(rprng.threefry_seed(123), 42)
    want = rprng.threefry_bits(key, n, partitionable)
    assert np.array_equal(tprng.threefry_bits(key, n, partitionable), want)
    old = bool(jax.config.jax_threefry_partitionable)
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        jkey = jax.random.fold_in(jax.random.PRNGKey(123, impl="threefry2x32"), 42)
        assert np.array_equal(np.asarray(jax.random.bits(jkey, (n,), jnp.uint32)), want)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    if not partitionable:   # the torch draw's layout: row 42 of seed 123
        thresh = rprng.ratio_threshold(0.3)
        mask = tprng.counter_fault_masks_torch(n, 0.3, 1, 123, 42, device="cpu")
        assert np.array_equal(mask.numpy()[0], want < thresh)


@pytest.mark.parametrize("nodes", [1, 2, 63, 64, 257, 1000])
@pytest.mark.parametrize("ratio", [0.0, 0.0233, 1.0])
@pytest.mark.parametrize("start", [0, 16, 2**32 + 5])
def test_counter_fault_masks_torch_matches_numpy(nodes, ratio, start):
    want = rprng.counter_fault_masks(nodes, ratio, 9, seed=42, start=start)
    got = tprng.counter_fault_masks_torch(nodes, ratio, 9, 42, start, device="cpu")
    assert got.dtype == torch.bool and tuple(got.shape) == (9, nodes)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tprng.counter_fault_masks(nodes, ratio, 9, seed=42,
                                                    start=start), want)


def test_counter_fault_masks_torch_row_steps(monkeypatch):
    """Rows drawn in several bounded steps equal one step's rows."""
    want = rprng.counter_fault_masks(301, 0.07, 40, seed=3, start=7)
    monkeypatch.setattr(tprng, "_TORCH_BLOCK_LANES", 151 * 6)   # 6 rows a step
    got = tprng.counter_fault_masks_torch(301, 0.07, 40, 3, 7, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert tprng.counter_fault_masks_torch(301, 0.07, 0, 3, device="cpu").shape == (0, 301)


@pytest.mark.parametrize("nodes,ratio,samples,seed,start,digest", IID_PINS)
def test_digest_pins(nodes, ratio, samples, seed, start, digest):
    assert _sha(tprng.counter_fault_masks(nodes, ratio, samples, seed=seed,
                                          start=start)) == digest
    assert _sha(tprng.counter_fault_masks_torch(nodes, ratio, samples, seed, start,
                                                device="cpu").numpy()) == digest


def test_counter_draw_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        tprng.counter_fault_masks_torch(64, 0.07, 2, 0)
