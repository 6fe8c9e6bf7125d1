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
from repro_torch.kernels.prefix_scan.prefix_scan import (BLOCK_LENGTH, BLOCK_TILES,
                                                        BLOCKS_PER_SM, ITEMS, THREADS,
                                                        WARPS_PER_SM, ScanRoute, scan_route)

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


# ------------------------------------------------------------ routes
#
# The wrapper picks the kernel's route from the shape (scan_route); the CUDA
# kernel itself is held to the plain version on every route by chip_smoke.py.

SMS = 132                                     # an H100's SMs
RESIDENT = SMS * BLOCKS_PER_SM                # blocks a persistent grid keeps


@pytest.mark.parametrize("length,lanes", [
    (1, 1), (3, 1), (4, 1), (5, 2), (8, 2), (9, 4), (15, 4), (16, 4), (17, 8),
    (31, 8), (32, 8), (33, 16), (63, 16), (64, 16), (65, 32), (127, 32), (128, 32)])
def test_route_lanes_at_length_thresholds(length, lanes):
    r = scan_route(1000, length, 0, True, SMS)
    assert r.route == "warp" and r.lanes == lanes
    assert r.lanes * ITEMS >= length and (lanes == 1 or (lanes // 2) * ITEMS < length)
    assert r.vec == (length % ITEMS == 0)


@pytest.mark.parametrize("length", [129, 257, 513, 1023, 1024])
def test_route_warp_up_to_the_block_length_at_any_row_count(length):
    for rows in (1, 7, SMS * WARPS_PER_SM - 1, SMS * WARPS_PER_SM):
        r = scan_route(rows, length, 0, True, SMS)
        assert r.route == "warp" and r.lanes == 32 and r.grid == min(-(-rows // 8), RESIDENT)
    assert BLOCK_LENGTH == 1024


@pytest.mark.parametrize("length", [1025, 2048, 8191, 8192, 8193, 10000])
def test_route_block_below_the_warp_fill_and_warp_above(length):
    fill = SMS * WARPS_PER_SM                 # rows = warps at 32 lanes a row
    below = scan_route(fill - 1, length, 0, True, SMS)
    above = scan_route(fill, length, 0, True, SMS)
    assert below == ScanRoute("block", 0, length % ITEMS == 0, RESIDENT)
    assert above == ScanRoute("warp", 32, length % ITEMS == 0, -(-fill // 8))
    assert scan_route(1, length, 0, True, SMS) == ScanRoute("block", 0, length % 4 == 0, 1)


@pytest.mark.parametrize("rows,length,grid", [
    (1024, 2048, 2 * SMS),                    # 2 tiles a row: ~4 rows a block
    (256, 2048, 256),                         # never more blocks than rows
    (1024, 4096, 512),                        # BLOCK_TILES tiles a block
    (1024, 8192, 1024),                       # a block a row
    (4000, 1025, 1000),                       # 2 tiles a row, the last one ragged
    (4000, 8192, RESIDENT),                   # the persistent grid
    (1, 1 << 20, 1)])
def test_route_block_grid(rows, length, grid):
    r = scan_route(rows, length, 0, True, SMS)
    assert r.route == "block" and r.grid == grid
    assert grid == min(rows, RESIDENT, max(2 * SMS, -(-rows * -(-length // 1024) // BLOCK_TILES)))


@pytest.mark.parametrize("kind", [0, 1])
def test_route_vector_access_needs_alignment_and_whole_vectors(kind):
    assert scan_route(64, 64, kind, True, SMS).vec
    assert not scan_route(64, 64, kind, False, SMS).vec
    assert not scan_route(64, 66, kind, True, SMS).vec
    assert scan_route(7, 8192, kind, False, SMS) == ScanRoute("block", 0, False, 7)


@pytest.mark.parametrize("rows_per_warp,length", [(32, 3), (16, 8), (2, 64), (1, 200)])
def test_route_grid_below_and_above_the_persistent_grid(rows_per_warp, length):
    full = RESIDENT * (THREADS // 32) * rows_per_warp     # rows that fill the grid exactly
    assert scan_route(full, length, 0, True, SMS).grid == RESIDENT
    assert scan_route(4 * full, length, 0, True, SMS).grid == RESIDENT
    less = scan_route(full // 2, length, 0, True, SMS)
    assert less.route == "warp" and less.grid == -(-full // 2 // rows_per_warp // 8)
    assert scan_route(1, length, 0, True, SMS).grid == 1
    # the grid follows the card's SMs
    assert scan_route(4 * full, length, 0, True, 2 * SMS).grid == 2 * RESIDENT


# every shape the main paths launch (chip_smoke.py's launch histogram of
# phases 28-38 and 42 on an H100) and the route it is meant to take: the
# block route for rows past 1024 entries below 4224 rows, else the warp
# route with the narrowest team that covers a row (rows of 8 entries: 2
# lanes; 64: 16; 192 and more: 32)
CHURN_ROWS = (6, 71, 914, 939, 970, 974, 978, 988, 1007, 1017, 1020, 1021, 1023, 1024, 1033,
              1035, 1053, 1059, 1060, 1063, 1080, 1081, 1082, 1092, 1104, 1110, 1111, 1128,
              1132, 1133, 1140, 1142, 1148, 1163, 1168, 1173, 1177, 1179, 1184, 1194, 1200,
              1206, 1208, 1211, 1217, 1219, 1225, 1226, 1229, 1234, 1244, 1245, 1264, 1269,
              1282, 1298, 1337, 1339, 1342, 2596, 2991, 4096)
HISTOGRAM = {
    ("block", 0): [(1, 8192), (1, 10000), (16, 10000), (125, 2048), (256, 8192), (500, 2048),
                   (927, 2048), (1024, 8192), (4096, 2048), (4096, 10000)],
    ("warp", 32): [(25, 512), (29, 192), (50, 768), (100, 512), (136, 192), (200, 768),
                   (204, 192), (336, 192), (1000, 720), (8192, 10000), (16384, 10000),
                   (16960, 10000), (65536, 10000)] + [(r, 400) for r in CHURN_ROWS],
    ("warp", 16): [(128, 64), (4000, 64), (16000, 64), (29664, 64), (131072, 64)],
    ("warp", 2): [(696, 8), (3264, 8), (4896, 8), (6400, 8), (8064, 8), (1048576, 8)],
}


@pytest.mark.parametrize("route,lanes", list(HISTOGRAM))
def test_route_of_every_main_path_shape(route, lanes):
    for rows, length in HISTOGRAM[(route, lanes)]:
        r = scan_route(rows, length, 0, True, SMS)
        assert (r.route, r.lanes, r.vec) == (route, lanes, True), (rows, length, r)
        assert 1 <= r.grid <= min(rows, RESIDENT)


MAIN_PATH_ROUTES = [
    ((131072, 64), ScanRoute("warp", 16, True, RESIDENT)),        # DCN tier carve, 8192 nodes
    ((1024, 8192), ScanRoute("block", 0, True, 1024)),            # DCN residual carve
    ((65536, 10000), ScanRoute("warp", 32, True, RESIDENT)),      # the sweep's block
    ((500, 2048), ScanRoute("block", 0, True, 2 * SMS)),          # Fig. 17c's residual carve
    ((1, 10000), ScanRoute("block", 0, True, 1)),                 # the zoo's chunk-1 rows
    ((1048576, 8), ScanRoute("warp", 2, True, RESIDENT)),         # the matrix's 8-entry rows
]


@pytest.mark.parametrize("shape,route", MAIN_PATH_ROUTES)
def test_route_of_main_path_shapes(shape, route):
    assert scan_route(*shape, 0, True, SMS) == route


# the DCN engine's tier and residual carves at a small row count, and
# lengths at the routes' thresholds, against repro's three references
DCN_SHAPES = [(4, 16, 8, 64), (4, 8192), (3, 2, 65), (5, 129), (2, 513), (3, 257),
              (6, 17), (7, 33), (3, 1023), (2, 1025), (2, 8193)]


@pytest.mark.parametrize("shape", DCN_SHAPES)
@pytest.mark.parametrize("kind", ["bool", "uint8", "int32"])
def test_dcn_and_threshold_shapes_match_repro(shape, kind):
    seed = _seed(shape)
    a = {"bool": _masks(shape, seed=seed, p=0.07),
         "uint8": (np.abs(_ints(shape, seed)) % 256).astype(np.uint8),
         "int32": _ints(shape, seed)}[kind]
    got = _port(a)
    assert np.array_equal(got, np.asarray(jax_prefix_scan_ref(jnp.asarray(a))))
    assert np.array_equal(got, np.cumsum(a, -1, dtype=np.int32))
    if kind == "bool":
        assert np.array_equal(got, host_mask_cumsum(a))
    rows = a.reshape(-1, shape[-1])
    block = min(1024, shape[-1])
    want = np.asarray(prefix_scan_pallas(jnp.asarray(rows), block=block,
                                         row_block=min(64, rows.shape[0]), interpret=True))
    assert np.array_equal(got.reshape(rows.shape), want)


def test_int32_sums_past_2_31_wrap_as_repro():
    x = np.random.default_rng(3).integers(1 << 20, 1 << 21, (3, 8192), dtype=np.int32)
    got = _port(x)
    assert (got[:, -1] < 0).all()             # the sums wrapped
    assert np.array_equal(got, np.asarray(jax_prefix_scan_ref(jnp.asarray(x))))
