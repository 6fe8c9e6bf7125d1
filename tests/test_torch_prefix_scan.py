"""The port's prefix scan against the JAX package's three references.

On CPU tensors ``repro_torch.kernels.prefix_scan.prefix_scan`` takes its
plain version; it must be bit-equal to ``repro``'s sequential
``prefix_scan_ref``, to ``prefix_scan_pallas`` in interpret mode (as
``tests/test_prefix_scan.py`` runs it) and to the host twin
``mask_cumsum``.  The CUDA kernel is held to the plain version by
``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prefix_scan.host import mask_cumsum as host_mask_cumsum
from repro.kernels.prefix_scan.prefix_scan import prefix_scan_pallas
from repro.kernels.prefix_scan.ref import prefix_scan_ref as jax_prefix_scan_ref
from repro_torch.kernels.prefix_scan import mask_cumsum, prefix_scan, prefix_scan_ref

# tests/test_prefix_scan.py's shape sweep, and empty shapes
SHAPES = [(1, 0), (1, 1), (3, 7), (64, 8), (16, 128), (8, 129),
          (8, 300), (2, 1024), (4, 3, 40), (2, 3, 4, 8), (0, 5),
          (0, 0), (3, 0, 4), (2, 1), (1, 257)]
# shapes small enough for the Pallas kernel in interpret mode, with its
# (block, row_block) tiling
PALLAS = [((5, 37), 16, 2), ((3, 128), 128, 8), ((2, 300), 128, 8),
          ((9, 130), 64, 4), ((1, 1), 128, 8), ((4, 3, 40), 16, 8)]


def _masks(shape, seed=0, p=0.3):
    return np.random.default_rng(seed).random(shape) < p


def _ints(shape, seed=0):
    return np.random.default_rng(seed).integers(-1000, 1000, shape, dtype=np.int32)


def _seed(shape):
    return sum(shape) * 31 + len(shape)


def _port(a):
    out = prefix_scan(torch.from_numpy(a))
    assert out.dtype == torch.int32 and tuple(out.shape) == a.shape
    return out.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_bool_matches_jax_ref_and_host_mask_cumsum(shape):
    m = _masks(shape, seed=_seed(shape))
    got = _port(m)
    assert np.array_equal(got, np.asarray(jax_prefix_scan_ref(jnp.asarray(m))))
    assert np.array_equal(got, host_mask_cumsum(m))
    assert np.array_equal(mask_cumsum(torch.from_numpy(m)).numpy(), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_int32_and_uint8_match_jax_ref(shape):
    x = _ints(shape, seed=_seed(shape))
    assert np.array_equal(_port(x), np.asarray(jax_prefix_scan_ref(jnp.asarray(x))))
    u = (np.abs(x) % 256).astype(np.uint8)
    assert np.array_equal(_port(u), np.asarray(jax_prefix_scan_ref(jnp.asarray(u))))


@pytest.mark.parametrize("shape,block,row_block", PALLAS)
@pytest.mark.parametrize("kind", ["bool", "int32"])
def test_matches_pallas_interpret(shape, block, row_block, kind):
    a = _masks(shape, seed=block) if kind == "bool" else _ints(shape, seed=block)
    rows = a.reshape(-1, shape[-1])                 # the Pallas kernel is 2-D
    want = np.asarray(prefix_scan_pallas(jnp.asarray(rows), block=block,
                                         row_block=row_block, interpret=True))
    assert np.array_equal(_port(a).reshape(rows.shape), want)


def test_dense_long_row_and_sweep_width():
    ones = np.ones((2, 1 << 16), bool)
    assert np.array_equal(_port(ones)[:, -1], [1 << 16, 1 << 16])
    m = _masks((16, 10000), seed=5, p=0.07)
    assert np.array_equal(_port(m), host_mask_cumsum(m))


@pytest.mark.parametrize("view", ["transpose", "column_slice", "row_step", "offset"])
def test_non_contiguous_views(view):
    base = _masks((12, 40), seed=7)
    t = torch.from_numpy(base)
    sub, want = {
        "transpose": (t.T, base.T),
        "column_slice": (t[:, 3:33], base[:, 3:33]),
        "row_step": (t[::3], base[::3]),
        "offset": (t[1:], base[1:]),
    }[view]
    assert np.array_equal(prefix_scan(sub).numpy(), host_mask_cumsum(want))
    assert np.array_equal(prefix_scan_ref(sub).numpy(), np.cumsum(want, -1, dtype=np.int32))


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.float32])
def test_mask_cumsum_refuses_non_bool(dtype):
    with pytest.raises(TypeError, match="boolean"):
        mask_cumsum(torch.ones((2, 4), dtype=dtype))
    with pytest.raises(TypeError):
        host_mask_cumsum(np.ones((2, 4), np.int32))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        prefix_scan(torch.ones((2, 4), dtype=torch.bool, device="meta"))
