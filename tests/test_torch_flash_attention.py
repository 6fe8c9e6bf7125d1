"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run their plain versions, so these
tests hold those versions (the kernels' oracles on the card) to the Pallas
kernel in interpret mode, to ``attention_ref``, to ``_flash_fwd_impl``'s
lse and to ``jax.vjp`` of ``flash_attention_xla``.  Inputs come from a
numpy seed and go to both frameworks.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.layers import _flash_fwd_impl, flash_attention_xla
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_ref)
from repro_torch.models.layers import flash_attention as layers_flash_attention

# the tolerances of tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Gradients sum over up to Sq * rep (dK, dV) or Sk (dQ) products whose
# order differs between the frameworks, and both recompute the scores from
# (q, k, lse); in float32 that leaves errors of a few 1e-6 on gradients of
# size ~1-10, so 1e-5 relative to the gradient's largest entry.
GRAD_TOL = 1e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the five mask cases of tests/test_kernels.py: (sq, sk, hq, hkv, d, mask)
CASES = [
    (128, 128, 4, 2, 64, dict(causal=True)),
    (256, 256, 2, 2, 32, dict(causal=True, window=100)),
    (128, 128, 4, 1, 64, dict(causal=True, chunk=32)),
    (96, 96, 2, 2, 64, dict(causal=True, prefix_len=17)),
    (64, 192, 2, 1, 128, dict(causal=False)),
]
IDS = ["causal", "window", "chunk", "prefix", "noncausal"]
# head dim 256 (PaliGemma's and RecurrentGemma's heads, the bf16 kernels'
# DMAX-256 tiles on the card): GQA 4/2, a window and a chunk.  The chunk
# divides the Pallas kernel's 64-row blocks: its block-level chunk skip
# (`_flash_kernel`) compares only the blocks' first and last rows, so with
# chunk 48 it skips q rows 64-95 against keys 48-63 (one chunk) and fails
# against `attention_ref`; a limit of the reference, not of the port.
CASES_256 = [
    (128, 128, 4, 2, 256, dict(causal=True)),
    (192, 192, 4, 2, 256, dict(causal=True, window=80)),
    (128, 128, 4, 2, 256, dict(causal=True, chunk=32)),
]
IDS_256 = ["causal-d256", "window-d256", "chunk-d256"]


def _inputs(seed, b, sq, sk, hq, hkv, d, dtype):
    """(q, k, v, g) as JAX arrays and as torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                            (b, sq, hq, d))]
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return jx, tx


def _close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,hq,hkv,d,kw", CASES + CASES_256, ids=IDS + IDS_256)
def test_plain_forward_matches_pallas_and_ref(dtype, sq, sk, hq, hkv, d, kw):
    (qj, kj, vj, _), (qt, kt, vt, _) = _inputs(sq + d, 2, sq, sk, hq, hkv, d, dtype)
    out, lse = flash_attention_fwd(qt, kt, vt, **kw)
    assert out.dtype == TDT[dtype] and out.shape == qt.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, hq, sq)
    ref_out, ref_lse = flash_attention_fwd_ref(qt, kt, vt, **kw)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert torch.equal(flash_attention(qt, kt, vt, **kw), out)
    _close(out, attention_ref(qj, kj, vj, **kw), TOL[dtype])
    pallas = flash_attention_pallas(qj, kj, vj, block_q=64, block_k=64,
                                    interpret=True, **kw)
    _close(out, pallas, TOL[dtype])


def _grad_close(t: torch.Tensor, j):
    j = np.asarray(j, np.float32)
    err = np.abs(t.float().numpy() - j).max()
    assert err <= GRAD_TOL * max(1.0, np.abs(j).max()), err


@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("sq,sk,hq,hkv,d,kw", CASES + CASES_256, ids=IDS + IDS_256)
def test_plain_lse_and_backward_match_jax(sq, sk, hq, hkv, d, kw, block):
    """out and lse against ``_flash_fwd_impl``, (dq, dk, dv) against
    ``jax.vjp`` of ``flash_attention_xla``, at blocks that scan several KV
    blocks."""
    (qj, kj, vj, gj), (qt, kt, vt, gt) = _inputs(11 + sk, 2, sq, sk, hq, hkv, d, "float32")
    cfg = (kw.get("causal", True), kw.get("window", 0), kw.get("chunk", 0),
           kw.get("prefix_len", 0))
    jout, jlse = _flash_fwd_impl(qj, kj, vj, cfg, 0, block)
    out, lse = flash_attention_fwd_ref(qt, kt, vt, block=block, **kw)
    _close(out, jout, TOL["float32"])
    _close(lse, np.asarray(jlse).reshape(2, hq, sq), TOL["float32"])
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_xla(q, k, v, block=block, **kw),
                     qj, kj, vj)
    jgrads = vjp(gj)
    grads = flash_attention_bwd_ref(qt, kt, vt, out, lse, gt, block=block, **kw)
    for t, j, x in zip(grads, jgrads, (qt, kt, vt)):
        assert t.shape == x.shape and t.dtype == x.dtype
        _grad_close(t, j)
    # the wrapper's CPU path is the plain version with its default block
    wrapped = flash_attention_bwd(qt, kt, vt, out, lse, gt, **kw)
    for t, j in zip(wrapped, jgrads):
        _grad_close(t, j)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=6),
                                dict(causal=True, chunk=8),
                                dict(causal=True, prefix_len=5), dict(causal=False)],
                         ids=IDS)
def test_autograd_function_gradcheck_float64(kw):
    rng = np.random.default_rng(5)
    b, s, hq, hkv, d = 1, 16, 2, 1, 8
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=torch.float64,
                            requires_grad=True)
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, **kw), (q, k, v), fast_mode=True)


def test_autograd_grads_and_q_offset_match_jax():
    """Sq < Sk with a query offset (a continued prefill): the autograd
    Function's gradients equal jax.vjp's; the model layer routes to it."""
    (qj, kj, vj, gj), (qt, kt, vt, gt) = _inputs(3, 2, 48, 112, 4, 2, 16, "float32")
    kw = dict(causal=True, window=40, q_offset=64)
    jout, vjp = jax.vjp(lambda q, k, v: flash_attention_xla(q, k, v, block=32, **kw),
                        qj, kj, vj)
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    out = layers_flash_attention(qt, kt, vt, **kw)
    _close(out.detach(), jout, TOL["float32"])
    for t, j in zip(torch.autograd.grad(out, (qt, kt, vt), gt), vjp(gj)):
        _grad_close(t, j)


def test_cpu_path_launches_nothing_and_checks_reject_bad_inputs():
    from repro_torch.kernels.flash_attention.flash_attention import _check

    before = (flash_attention.launches, flash_attention_bwd.launches)
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    flash_attention_bwd(q, kv, kv, *flash_attention_fwd(q, kv, kv), q)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    _check(q, kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        _check(torch.zeros(1, 8, 4, 12), torch.zeros(1, 8, 2, 12), torch.zeros(1, 8, 2, 12))
    with pytest.raises(ValueError, match="mismatch"):
        _check(torch.zeros(1, 8, 3, 16), kv, kv)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="contiguous"):
        _check(torch.zeros(1, 8, 4, 32)[..., ::2], kv, kv)
    # meta tensors (the dry run) give empty outputs of the kernel's shapes
    # and launch nothing; inputs on two devices are refused
    out, lse = flash_attention_fwd(q.to("meta"), kv.to("meta"), kv.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape and lse.shape == (1, 4, 8)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="several devices"):
        flash_attention_fwd(q.to("meta"), kv, kv)


def test_tensor_map_spec_reads_strides_of_views():
    """The plan of one tensor map: dims {D, H, S, B}, byte strides of H, S
    and B, a box of 64 columns x rows; a view cut from a packed QKV tensor
    keeps the packed strides."""
    from repro_torch.kernels.flash_attention.flash_attention import tensor_map_spec

    q = torch.zeros(2, 100, 24, 128, dtype=torch.bfloat16)
    assert tensor_map_spec(q.shape, q.stride(), 2, 128) == [
        128, 24, 100, 2, 256, 24 * 256, 100 * 24 * 256, 64, 1, 128, 1]
    qkv = torch.zeros(2, 100, 28, 128, dtype=torch.bfloat16)
    k = qkv[:, :, 24:26]
    spec = tensor_map_spec(k.shape, k.stride(), k.element_size(), 64)
    assert spec[:4] == [128, 2, 100, 2]
    assert spec[4:7] == [256, 28 * 256, 100 * 28 * 256]
    assert spec[7:] == [64, 1, 64, 1]
    assert all(st % 16 == 0 for st in spec[4:7])
    d32 = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)   # D < 64: the box reads zeros past D
    assert tensor_map_spec(d32.shape, d32.stride(), 2, 128)[:7] == [32, 2, 8, 1, 64, 128, 1024]


@pytest.mark.parametrize("kind,d", [(k, d) for d in (64, 256) for k in ("fwd", "dkdv", "dq")],
                         ids=["fwd", "dkdv", "dq", "fwd-d256", "dkdv-d256", "dq-d256"])
def test_tensor_maps_plan_each_kernel(kind, d):
    """q, k, v and dO maps with the query-side and key-side rows of the
    kernel's tile; the forward has no dO map.  At D = 256 a row is four
    64-column boxes and the streamed tiles are smaller (the shared-memory
    ring of the DMAX-256 kernels)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    k_ = {"fwd": fa.FWD, "dkdv": fa.DKDV, "dq": fa.DQ}[kind]
    q = torch.zeros(1, 300, 4, d, dtype=torch.bfloat16)
    kv = torch.zeros(1, 200, 2, d, dtype=torch.bfloat16)
    g = None if kind == "fwd" else q
    plan = fa.tensor_maps(k_, q, kv, kv, g)
    assert len(plan) == 4 * fa.MAP_SPEC_LEN
    q_rows, k_rows = fa.tile_rows(k_, d)
    assert (q_rows, k_rows) == fa.TILE_ROWS[fa.dmax(d)][k_]
    maps = [plan[i:i + fa.MAP_SPEC_LEN] for i in range(0, len(plan), fa.MAP_SPEC_LEN)]
    assert maps[0][:4] == [d, 4, 300, 1] and maps[0][9] == q_rows
    assert maps[1][:4] == [d, 2, 200, 1] and maps[1][9] == k_rows
    assert maps[2] == maps[1]
    assert maps[3] == ([0] * fa.MAP_SPEC_LEN if g is None else maps[0])
    assert all(m[7] == fa.TMA_BOX_COLS == 64 for m in maps if any(m))
    if d == 64:
        assert fa.dmax(d) // fa.TMA_BOX_COLS == 1
        assert q_rows in (64, 128) and k_rows in (64, 128)
    else:
        assert fa.dmax(d) // fa.TMA_BOX_COLS == 4
        assert (q_rows, k_rows) == {"fwd": (128, 64), "dkdv": (64, 64), "dq": (128, 32)}[kind]


def test_tensor_core_path_and_scratch_plan():
    from repro_torch.kernels.flash_attention.flash_attention import (dkv_partial_shape,
                                                                     uses_tensor_maps)

    assert uses_tensor_maps(torch.bfloat16, 128) and uses_tensor_maps(torch.bfloat16, 32)
    # bf16 heads past 128 take the DMAX-256 Hopper kernels; float32 never
    assert uses_tensor_maps(torch.bfloat16, 136) and uses_tensor_maps(torch.bfloat16, 256)
    assert not uses_tensor_maps(torch.float32, 64)
    assert not uses_tensor_maps(torch.float32, 256)
    assert dkv_partial_shape(1, 4096, 8, 256) == (2, 1, 4096, 8, 256)
    # fp32 dK and dV of every query head, summed over each KV group afterwards
    assert dkv_partial_shape(1, 4096, 24, 128) == (2, 1, 4096, 24, 128)
    assert 4 * math.prod(dkv_partial_shape(1, 4096, 24, 128)) == 2 * 50331648


def test_check_rejects_what_the_bf16_kernels_cannot_take():
    from repro_torch.kernels.flash_attention.flash_attention import _check

    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    _check(q, kv, kv)
    with pytest.raises(ValueError, match="empty sequence"):
        _check(q[:, :0], kv, kv)
    with pytest.raises(ValueError, match="empty sequence"):
        _check(q, kv[:, :0], kv[:, :0])
    # a KV head broadcast over the query heads has stride 0: no tensor map
    shared = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16).expand(1, 8, 2, 64)
    with pytest.raises(ValueError, match="broadcast"):
        _check(q, shared, kv)
    # the fp32 kernels read rows through pointers and take it
    _check(q.float(), shared.float(), kv.float())
    # at D = 256 bf16 takes the tensor maps too (no quiet fp32 path), float32 not
    q256 = torch.zeros(1, 8, 4, 256, dtype=torch.bfloat16)
    kv256 = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)
    shared256 = torch.zeros(1, 8, 1, 256, dtype=torch.bfloat16).expand(1, 8, 2, 256)
    _check(q256, kv256, kv256)
    with pytest.raises(ValueError, match="broadcast"):
        _check(q256, shared256, kv256)
    _check(q256.float(), shared256.float(), kv256.float())


# The float32 kernels run every product on the tensor cores as three TF32
# products (3xTF32): x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
# (cvt.rna), and a b = lo.hi + hi.lo + hi.hi, summed in float32.  The card
# holds the kernels to their plain versions; these tests hold the
# arithmetic itself, emulated in numpy, to float32's tolerance.

def _tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the 13 low bits of the pattern cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a, b, products):
    """a @ b as the kernels' tensor cores take it: three split products
    (the cross terms first, lo.lo dropped) or one TF32 product.  A product
    of two TF32 values is exact in float32, so float32 matmuls emulate the
    fp32 accumulation."""
    if products == 1:
        return _tf32(a) @ _tf32(b)
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def test_tf32_rounding_clears_13_bits_with_ties_away_from_zero():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 100
    hi = _tf32(x)
    assert not np.any(hi.view(np.uint32) & np.uint32(0x1FFF))
    assert np.all(np.abs(hi.astype(np.float64) - x) <= 2.0 ** -11 * np.abs(x))
    one = np.float32(1.0).view(np.uint32)
    below, tie, above = (np.array([one + n], np.uint32).view(np.float32)
                         for n in (0xFFF, 0x1000, 0x1001))
    up = np.array([one + 0x2000], np.uint32).view(np.float32)
    assert _tf32(below)[0] == 1.0 and _tf32(above)[0] == up[0]
    # a tie above an even mantissa goes away from zero on both sides: to
    # nearest even it would stay at 1
    assert _tf32(tie)[0] == up[0] and _tf32(-tie)[0] == -up[0]


def test_tf32_split_reproduces_float32():
    x = np.random.default_rng(1).standard_normal(1 << 16).astype(np.float32)
    x = np.concatenate([x, x * 1e-20, x * 1e20])
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22
    assert np.all(np.abs(lo) <= 2.0 ** -11 * np.abs(x))


@pytest.fixture(scope="module")
def whisper_reduced():
    """Inputs at a reduced Whisper encoder shape (B=1, 1500 frames, 2
    heads, D=64, non-causal) and ``repro``'s out, lse and gradients."""
    b, s, h, d = 1, 1500, 2, 64
    rng = np.random.default_rng(25)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4))
    cfg = (False, 0, 0, 0)
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    out, lse = _flash_fwd_impl(qj, kj, vj, cfg, 0, 512)
    from repro.models.layers import _flash_vjp_bwd
    grads = _flash_vjp_bwd(cfg, 0, 512, (qj, kj, vj, out, lse), jnp.asarray(g))
    ref = dict(out=out, lse=np.asarray(lse).reshape(b, h, s),
               **dict(zip(("dq", "dk", "dv"), grads)))
    return (q, k, v, g), {n: np.asarray(x, np.float32) for n, x in ref.items()}


@pytest.mark.parametrize("products", [3, 1], ids=["3xtf32", "one-tf32"])
def test_split_products_hold_float32_tolerance_at_whisper_shape(whisper_reduced, products):
    """Attention and its three gradients with every product (q k^T, p v,
    dO v^T, p^T dO, ds^T q, ds k) done as the kernels do it: three split
    products match ``_flash_fwd_impl`` and ``_flash_vjp_bwd`` within
    TOL["float32"]; one TF32 product misses it on out and every gradient."""
    (q, k, v, g), ref = whisper_reduced
    qt, kt, vt, gt = (x.transpose(0, 2, 1, 3) for x in (q, k, v, g))   # (B, H, S, D)
    scale = np.float32(1.0 / math.sqrt(q.shape[-1]))
    s = _mm(qt, kt.swapaxes(-1, -2), products) * scale
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    out = _mm(p, vt, products) / l
    lse = m + np.log(l)
    p = np.exp(s - lse)                               # the backward's recomputed p
    ds = p * (_mm(gt, vt.swapaxes(-1, -2), products) - (gt * out).sum(-1, keepdims=True)) * scale
    got = dict(out=out, lse=lse[..., 0], dv=_mm(p.swapaxes(-1, -2), gt, products),
               dk=_mm(ds.swapaxes(-1, -2), qt, products), dq=_mm(ds, kt, products))
    tol = TOL["float32"]
    within = {}
    for name, x in got.items():
        x = x if name == "lse" else x.transpose(0, 2, 1, 3)
        assert x.shape == ref[name].shape
        within[name] = bool(np.all(np.abs(x - ref[name]) <= tol + tol * np.abs(ref[name])))
    if products == 3:
        assert all(within.values()), within
    else:
        assert not any(within[n] for n in ("out", "dq", "dk", "dv")), within
