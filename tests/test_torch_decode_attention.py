"""The port's flash-decode against the JAX package's, on the CPU.

On CPU tensors the port's wrapper runs its plain version, so these tests
hold that version (the kernel's oracle on the card) to the Pallas kernel
in interpret mode and to the JAX ``decode_attention_ref``, and the port's
ring-buffer form ``decode_attention_cache`` (wrapped lanes, empty slots,
windows and chunks) to ``decode_attention_cache_xla``.
Inputs come from a numpy seed and go to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro.models.layers import decode_attention_cache_xla
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_cache,
                                                  decode_attention_cache_ref,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention.decode_attention import (
    BLOCKS_PER_SM, HEADS_PER_BLOCK, MAX_MERGE, MAX_SPLITS, MERGE_ONE_STEP, MIN_SPLIT_KEYS, TILE_K,
    num_splits, plan)
from repro_torch.models import layers

# the tolerances of tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(JDT[dtype])
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return j, t


def _close(t: torch.Tensor, j, dtype: str):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2, 12])
@pytest.mark.parametrize("d", [16, 128])
def test_plain_decode_matches_pallas_and_ref(dtype, rep, d):
    rng = np.random.default_rng(1000 * rep + d)
    b, hkv, s, blk = 3, 2, 100, 32           # S not a multiple of the block
    hq = rep * hkv
    q = rng.standard_normal((b, hq, d))
    kc = rng.standard_normal((b, s, hkv, d))
    vc = rng.standard_normal((b, s, hkv, d))
    lengths = np.array([1, s, 37], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, kc, vc))
    lj, lt = jnp.asarray(lengths), torch.from_numpy(lengths)

    out = decode_attention(qt, kt, vt, lt)
    assert out.dtype == TDT[dtype] and out.shape == (b, hq, d)
    assert torch.equal(out, decode_attention_ref(qt, kt, vt, lt))
    _close(out, jax_ref(qj, kj, vj, lj), dtype)
    _close(out, decode_attention_pallas(qj, kj, vj, lj, block_k=blk,
                                        interpret=True), dtype)


def _reused_lane_cache(rng, b, w, hkv, d, q_pos):
    """A cache as ServeEngine leaves it: lane i holds positions
    0..q_pos[i] of its current request, and every later slot holds -1 or a
    stale position from an earlier, longer request in that lane."""
    k = rng.standard_normal((b, w, hkv, d))
    v = rng.standard_normal((b, w, hkv, d))
    slot_pos = np.full((b, w), -1, np.int32)
    for i, p in enumerate(q_pos):
        slot_pos[i, :p + 1] = np.arange(p + 1)
        stale_end = min(w, p + 1 + 5 * (i + 1))  # earlier request ran further
        slot_pos[i, p + 1:stale_end] = np.arange(p + 1, stale_end)
    return k, v, slot_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_attention_matches_xla_on_reused_lanes(dtype):
    rng = np.random.default_rng(7)
    b, w, hq, hkv, d = 3, 24, 4, 2, 16
    q_pos = np.array([0, 9, 23], np.int32)
    k, v, slot_pos = _reused_lane_cache(rng, b, w, hkv, d, q_pos)
    q = rng.standard_normal((b, 1, hq, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    pj, pt = jnp.asarray(slot_pos), torch.from_numpy(slot_pos)
    qpj, qpt = jnp.asarray(q_pos), torch.from_numpy(q_pos)

    out = layers.decode_attention_cache(qt, kt, vt, pt, qpt)
    _close(out, decode_attention_cache_xla(qj, kj, vj, pj, qpj), dtype)
    # the kernel's length mask selects the same slots as the ring mask
    flash = decode_attention(qt[:, 0], kt, vt, qpt + 1)
    _close(flash, decode_attention_cache_xla(qj, kj, vj, pj, qpj)[:, 0], dtype)
    # windowed masks (the later SWA slice) agree as well
    _close(layers.decode_attention_cache(qt, kt, vt, pt, qpt, window=5),
           decode_attention_cache_xla(qj, kj, vj, pj, qpj, window=5), dtype)


def _ring_cache(rng, b, w, hkv, d, case):
    """(k, v, slot_pos, q_pos) of a ring-buffer cache of W slots, as
    ``_attn_decode`` leaves it: position t in slot t % W.  ``case``:
    "wrapped" lanes ran past W positions; "empty" lanes hold fewer than W
    (the rest -1) and one lane holds stale, larger positions of an earlier
    request; "mixed" has one lane of each."""
    k = rng.standard_normal((b, w, hkv, d))
    v = rng.standard_normal((b, w, hkv, d))
    q_pos = {"wrapped": [w + 3, 3 * w - 1, 2 * w],
             "empty": [0, w // 2, 5],
             "mixed": [2 * w + 7, 4, w - 1]}[case]
    slot_pos = np.full((b, w), -1, np.int32)
    for i, qp in enumerate(q_pos):
        for t in range(qp + 1):
            slot_pos[i, t % w] = t
    if case == "empty":             # lane 2 reuses a slot of a longer request
        slot_pos[2, 6:9] = [6 + w, 7 + w, 8 + w]
    return k, v, slot_pos, np.asarray(q_pos, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("case", ["wrapped", "empty", "mixed"])
@pytest.mark.parametrize("window, chunk", [(0, 0), (7, 0), (0, 8), (5, 16)])
def test_plain_slot_form_matches_xla(dtype, d, case, window, chunk):
    rng = np.random.default_rng([d, ["wrapped", "empty", "mixed"].index(case), window,
                                 chunk])
    b, w, hkv, rep = 3, 24, 2, 3
    k, v, slot_pos, q_pos = _ring_cache(rng, b, w, hkv, d, case)
    q = rng.standard_normal((b, 1, rep * hkv, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    pj, pt = jnp.asarray(slot_pos), torch.from_numpy(slot_pos)
    qpj, qpt = jnp.asarray(q_pos), torch.from_numpy(q_pos)
    before = decode_attention.launches
    out = decode_attention_cache(qt, kt, vt, pt, qpt, window=window, chunk=chunk)
    assert decode_attention.launches == before        # the CPU launches nothing
    assert out.dtype == TDT[dtype] and out.shape == (b, 1, rep * hkv, d)
    assert torch.equal(out, decode_attention_cache_ref(qt, kt, vt, pt, qpt,
                                                       window=window, chunk=chunk))
    assert torch.equal(out, layers.decode_attention_cache(qt, kt, vt, pt, qpt,
                                                          window=window, chunk=chunk))
    _close(out, decode_attention_cache_xla(qj, kj, vj, pj, qpj, window=window,
                                           chunk=chunk), dtype)


@pytest.mark.parametrize("b, hkv, rep, seq", [
    (8, 2, 12, 1024), (8, 2, 12, 4096), (1, 1, 1, 100), (64, 8, 4, 2048),
    (1, 2, 12, 65536), (4, 1, 40, 300), (1, 1, 1, 131073), (2, 2, 12, 1 << 20),
    (1, 1, 3, 32768), (8, 1, 10, 2048)])
def test_num_splits_whole_tiles_from_shapes(b, hkv, rep, seq):
    """Splits are whole tiles and none is empty.  Where MAX_SPLITS splits a
    row give at least half the SMs a block, the rule is the cluster's: at
    most MAX_SPLITS, about one block an SM.  With fewer rows (long_500k's
    shard, RecurrentGemma's ring: 1 and 8 rows) a row takes more splits,
    about BLOCKS_PER_SM blocks an SM, merged through device memory in
    groups of at most MAX_MERGE."""
    units = b * hkv * -(-rep // HEADS_PER_BLOCK)
    n, keys = num_splits(units, seq, 132)
    assert keys % TILE_K == 0
    assert (n - 1) * keys < seq <= n * keys          # no empty trailing split
    assert n == 1 or keys >= MIN_SPLIT_KEYS
    pl = plan(b, hkv * rep, hkv, seq, 132)
    assert (pl.units, pl.n_split, pl.split_keys) == (units, n, keys)
    if units * MAX_SPLITS >= 132 / 2:                # the cluster's rule, unchanged
        assert n <= min(MAX_SPLITS, -(-132 // units)) and pl.merge == "cluster"
    else:
        assert n <= min(-(-BLOCKS_PER_SM * 132 // units), MAX_MERGE ** 2)
    assert (pl.merge == "memory") == (n > MAX_SPLITS)
    if pl.merge == "memory":
        groups = -(-n // pl.group)
        assert pl.group <= MAX_MERGE and groups <= MAX_MERGE
        assert pl.group == n or (n > MERGE_ONE_STEP and groups <= pl.group)
    if (b, hkv, rep, seq) in ((1, 1, 3, 32768), (8, 1, 10, 2048)):
        assert n > MAX_SPLITS                        # the few-row shapes fill the card
        assert units * n >= 132 // 2


def test_wrapper_rejects_other_devices():
    """Meta tensors (the dry run) give empty outputs of the kernel's shapes
    and dtypes, launch nothing and report the kernel's work; inputs on two
    devices are refused."""
    from repro_torch.launch.op_analysis import OpAnalysis

    q = torch.zeros((1, 2, 8), device="meta", dtype=torch.bfloat16)
    kc = torch.zeros((1, 4, 2, 8), device="meta", dtype=torch.bfloat16)
    pos = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    qp = torch.zeros((1,), dtype=torch.int32, device="meta")
    before = decode_attention.launches
    with OpAnalysis() as an:
        out = decode_attention(q, kc, kc, qp)
        plain = decode_attention_cache(q[:, None], kc, kc, pos, qp)
        part, lse = decode_attention_cache(q[:, None], kc, kc, pos, qp, return_lse=True)
    assert decode_attention.launches == before
    assert out.device.type == "meta" and out.shape == (1, 2, 8) and out.dtype == torch.bfloat16
    assert plain.shape == (1, 1, 2, 8) and plain.dtype == torch.bfloat16
    assert part.shape == (1, 1, 2, 8) and part.dtype == torch.float32
    assert lse.shape == (1, 2) and lse.dtype == torch.float32
    rec = an.kernels["decode_attention"]
    assert rec["calls"] == 3
    assert rec["flops"] == 3 * 4 * 2 * 4 * 8             # 4 D a (head, slot) pair
    assert rec["transcendentals"] == 3 * 2 * 4
    # q, k, v, out (float32 and lse in the log-sum-exp form) and the masks
    cache_bytes = 2 * 2 * 4 * 2 * 8
    assert rec["bytes"] == (3 * 2 * 16 + 3 * cache_bytes + 2 * 2 * 16 + 4 * 16 + 4 * 2
                            + 4 + 2 * (16 + 4))
    with pytest.raises(ValueError, match="several devices"):
        decode_attention(q, torch.zeros((1, 4, 2, 8), dtype=torch.bfloat16), kc, qp)


def _merge(parts):
    """The softmax over every shard's slots from each shard's float32
    output and log-sum-exp: weights exp(lse - max lse)."""
    outs = torch.stack([o[:, 0] for o, _ in parts])                 # (n, B, Hq, D)
    lses = torch.stack([l for _, l in parts])                       # (n, B, Hq)
    w = torch.exp(lses - lses.amax(0))
    return ((w[..., None] * outs).sum(0) / w.sum(0)[..., None])[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["wrapped", "empty", "mixed"])
@pytest.mark.parametrize("window, chunk", [(0, 0), (7, 0), (0, 8), (5, 16)])
@pytest.mark.parametrize("n", [2, 4])
def test_lse_form_split_and_merged_matches_xla(dtype, case, window, chunk, n):
    """A ring cache's slots cut into n runs, as a sequence-sharded cache
    holds them: each run's float32 output and log-sum-exp, merged, equal
    ``decode_attention_cache_xla`` over the whole cache, runs with no valid
    slot (short lanes, windows, chunks) among them; the unsplit lse is the
    logsumexp of the masked logits."""
    rng = np.random.default_rng([n, ["wrapped", "empty", "mixed"].index(case), window, chunk])
    b, w, hkv, rep, d = 3, 24, 2, 3, 16
    k, v, slot_pos, q_pos = _ring_cache(rng, b, w, hkv, d, case)
    q = rng.standard_normal((b, 1, rep * hkv, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    pt, qpt = torch.from_numpy(slot_pos), torch.from_numpy(q_pos)
    kw = dict(window=window, chunk=chunk)
    step = w // n
    parts = [decode_attention_cache(qt, kt[:, i:i + step], vt[:, i:i + step],
                                    pt[:, i:i + step], qpt, return_lse=True, **kw)
             for i in range(0, w, step)]
    assert all(o.dtype == torch.float32 and l.shape == (b, rep * hkv) for o, l in parts)
    empty = [bool((l <= -1e29).any()) for _, l in parts]
    if case == "empty":
        assert any(empty)
    want = decode_attention_cache_xla(qj, kj, vj, jnp.asarray(slot_pos), jnp.asarray(q_pos),
                                      **kw)
    _close(_merge(parts).to(TDT[dtype]), want, dtype)
    out, lse = decode_attention_cache(qt, kt, vt, pt, qpt, return_lse=True, **kw)
    assert torch.equal(out.to(TDT[dtype]), decode_attention_cache(qt, kt, vt, pt, qpt, **kw))
    qf = qt[:, 0].float().reshape(b, hkv, rep, d) / np.sqrt(d)
    logits = torch.einsum("bgrd,bsgd->bgrs", qf, kt.float()).reshape(b, rep * hkv, w)
    from repro_torch.kernels.decode_attention.ref import slot_mask
    valid = slot_mask(pt, qpt, window, chunk)[:, None, :]
    torch.testing.assert_close(lse, torch.logsumexp(logits.masked_fill(~valid, -1e30), -1))
