"""The port's plain SSD scan and its gradient against the JAX package's.

Inputs are made from a numpy seed as ``tests/test_kernels.py`` makes them
(dt from softplus, A = -exp(.)) and handed to both frameworks.  The JAX
side is ``ssd_scan_pallas`` in interpret mode, ``repro``'s sequential
``ssd_scan_ref`` and the model's ``ssd_chunked``; gradients come from
``jax.vjp`` of ``ssd_chunked``.  On CPU tensors the port's wrapper takes
its plain version; its CUDA kernels are held to that plain version by
``chip_smoke.py`` on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref,
                                          ssd_scan_fwd, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import _check, head_groups

# the tolerances of tests/test_kernels.py: f32 sums run in another order;
# bf16 inputs are read the same, and y is rounded to bf16 once
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# gradients, as a share of the largest entry: dB and dC sum over the heads
# and the chunk in another order than XLA.  dA sums the cumsum's gradient
# over every position, whose terms cancel: against float64 JAX, f32 JAX is
# 8e-6 off and the plain version 2.5e-5 at (2, 128, 4, 64, 32, 128).
GRAD_TOL = {"dx": 2e-5, "ddt": 2e-5, "dA": 1e-4, "dB": 2e-5, "dC": 2e-5}
SHAPES = [  # (Bt, S, H, P, N, chunk), from tests/test_kernels.py's sweep
    (2, 64, 3, 16, 8, 16),
    (2, 128, 4, 64, 32, 128),
]


def _inputs(seed, bt, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bt, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((bt, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((bt, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _both(arrays, dtype):
    """The same values as JAX and torch arrays; x, B, C in ``dtype``."""
    x, dt, A, B, C = arrays
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    j = [jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B).astype(jdt), jnp.asarray(C).astype(jdt)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(B).to(tdt), torch.from_numpy(C).to(tdt)]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_scan_matches_pallas_ref_and_ssd_chunked(dtype, shape):
    bt, s, h, p, n, chunk = shape
    j, t = _both(_inputs(1, bt, s, h, p, n), dtype)
    y = ssd_scan_ref(*t, chunk)
    assert y.dtype == t[0].dtype and y.shape == (bt, s, h, p)
    got = y.float().numpy()
    tol = TOL[dtype]
    pallas = ssd_scan_pallas(*j, chunk=chunk)
    seq, _ = jax.jit(jax_ssd_scan_ref)(*j)
    chunked = jax.jit(jax_ssd_chunked, static_argnums=5)(*j, chunk)
    for want in (pallas, seq, chunked):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_plain_scan_is_chunk_invariant():
    _, t = _both(_inputs(3, 1, 128, 2, 16, 8), "float32")
    outs = [ssd_scan_ref(*t, c).numpy() for c in (16, 32, 128, 1000)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", SHAPES + [(1, 96, 2, 8, 16, 32)])
def test_plain_gradients_match_jax_grad_of_ssd_chunked(shape):
    bt, s, h, p, n, chunk = shape
    arrays = _inputs(4, bt, s, h, p, n)
    dy = np.random.default_rng(5).standard_normal((bt, s, h, p)).astype(np.float32)
    j, t = _both(arrays, "float32")
    want = jax.jit(lambda dy, *a: jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk), *a)[1](dy))(
        jnp.asarray(dy), *j)
    got = ssd_scan_bwd_ref(*t, torch.from_numpy(dy), chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL[name] * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("out", ["same", "float32"])
def test_autograd_function_on_cpu_takes_the_plain_versions(out):
    j, t = _both(_inputs(6, 2, 64, 3, 16, 8), "bfloat16")
    out_dtype = None if out == "same" else torch.float32
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 64, 3, 16))
                          .astype(np.float32)).to(out_dtype or torch.bfloat16)
    launches = (ssd_scan.launches, ssd_scan_bwd.launches)
    ins = [a.clone().requires_grad_() for a in t]
    y = ssd_scan(*ins, chunk=16, out_dtype=out_dtype)
    grads = torch.autograd.grad(y, ins, dy)
    assert y.dtype == (out_dtype or torch.bfloat16)
    torch.testing.assert_close(y, ssd_scan_ref(*t, 16, out_dtype), rtol=0, atol=0)
    want = ssd_scan_bwd_ref(*t, dy, 16)
    for a, g, w in zip(t, grads, want):
        assert g.dtype == a.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    fwd = ssd_scan_fwd(*t, chunk=16, out_dtype=out_dtype)
    assert fwd[1] is None and fwd[2] is None
    assert all(g.dtype == a.dtype
               for a, g in zip(t, ssd_scan_bwd(*t, dy, None, None, chunk=16)))
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == launches


def test_checks_reject_what_the_kernels_do_not_take():
    _, (x, dt, A, B, C) = _both(_inputs(8, 1, 64, 2, 16, 8), "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan_ref(x, dt, A, B, C, 24)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        _check(x, dt, A, B, C, 48, torch.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        _check(x, dt[:, :, :1], A, B, C, 16, torch.float32)
    with pytest.raises(ValueError, match="want x"):
        _check(x[0], dt, A, B, C, 16, torch.float32)
    with pytest.raises(TypeError, match="the same for all three"):
        _check(x, dt, A, B.bfloat16(), C, 16, torch.float32)
    with pytest.raises(TypeError, match="dt and A must be float32"):
        _check(x, dt.double(), A, B, C, 16, torch.float32)
    with pytest.raises(TypeError, match="x's dtype or float32"):
        _check(x, dt, A, B, C, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        _check(torch.cat([x, x], dim=-1)[..., ::2], dt, A, B, C, 16, torch.float32)
    with pytest.raises(ValueError, match="a multiple of 4"):
        _check(*_both(_inputs(8, 1, 64, 2, 5, 7), "float32")[1], 16, torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        _check(*_both(_inputs(8, 1, 64, 2, 12, 8), "bfloat16")[1], 16, torch.bfloat16)
    # meta tensors (the dry run) give empty outputs of the kernels' shapes;
    # inputs on two devices are refused
    y, states, T = ssd_scan_fwd(*(t.to("meta") for t in (x, dt, A, B, C)), chunk=16)
    assert y.device.type == "meta" and y.shape == x.shape and states.shape[:3] == (1, 4, 2)
    with pytest.raises(ValueError, match="several devices"):
        ssd_scan_fwd(x.to("meta"), dt, A, B, C, chunk=16)


@pytest.mark.parametrize("chunks, heads", [(128, 48), (32, 48), (5, 48), (3, 4), (1, 1),
                                           (200, 7), (64, 24)])
def test_head_groups_cover_every_head_within_one_wave(chunks, heads):
    """The bf16 backward's head groups: a block per (batch, chunk, group),
    every group non-empty, as many groups as one wave of 132 SMs holds."""
    g = head_groups(chunks, heads, 132)
    per = -(-heads // g)
    assert 1 <= g <= heads
    assert (g - 1) * per < heads <= g * per
    assert g == 1 or chunks * g <= 132
    assert head_groups(128, 48, 132) == 1        # Mamba2-780m's training shape


# The bf16 forward's launch plan at chip_smoke.py's card cases, (Bt, S, H,
# chunk): Mamba2-780m's training shape, an odd head count, 128 chunks, Bt x
# nc below and far above the SM count, a ragged chunk.
FWD_PLANS = [(4, 4096, 48, 128), (2, 512, 7, 128), (1, 16384, 4, 128), (1, 1024, 8, 128),
             (8, 8192, 4, 64), (2, 120, 3, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt, s, h, chunk", FWD_PLANS)
def test_forward_hands_the_kernels_its_plan(monkeypatch, dtype, bt, s, h, chunk):
    """What ``ssd_scan_fwd`` hands the C entry point for CUDA tensors, with
    the launch caught on the CPU: the outputs it allocates, the dims with
    the head groups of the bf16 output kernel (a block per (batch, chunk,
    group), as many groups as one wave of 132 SMs holds; float32 takes 1)
    and one count on ``ssd_scan.launches``."""
    wrapper = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    calls = []
    monkeypatch.setattr(wrapper, "_on", lambda t, name: True)
    monkeypatch.setattr(wrapper, "limits", lambda: (128, 128, 64))
    monkeypatch.setattr(wrapper, "_sm_count", lambda index: 132)
    monkeypatch.setattr(wrapper, "_launch", lambda *args: calls.append(args))
    p, n = 8, 16                     # the plan does not depend on them
    tdt = getattr(torch, dtype)
    x = torch.empty((bt, s, h, p), dtype=tdt)
    dt = torch.empty((bt, s, h))
    A = torch.empty((h,))
    B, C = (torch.empty((bt, s, n), dtype=tdt) for _ in range(2))
    launches = ssd_scan.launches
    y, states, T = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk, out_dtype=torch.float32)
    q = min(chunk, s)
    nc = s // q
    (kind, ptrs, strides, dims, arg, out_dtype), = calls
    groups = head_groups(bt * nc, h, 132) if dtype == "bfloat16" else 1
    assert kind == wrapper.FWD and arg is x and out_dtype == torch.float32
    assert dims == [bt, s, h, p, n, q, groups]
    assert ptrs == [t.data_ptr() for t in (x, dt, A, B, C, y, states, T)]
    assert strides == [*x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
                       *y.stride()[:3], 0, 0, 0]
    assert y.shape == x.shape and y.dtype == torch.float32
    assert states.shape == (bt, nc, h, n, p) and states.dtype == torch.float32
    assert states.is_contiguous() and T.shape == (bt, nc, h) and T.dtype == torch.float32
    assert ssd_scan.launches == launches + 1
    per = -(-h // groups)
    assert (groups - 1) * per < h <= groups * per
    assert groups == 1 or bt * nc * groups <= 132


def test_meta_limits_are_the_kernel_sources():
    """The meta branch checks against ``LIMITS``, a copy of the largest
    chunk, state size and head dim that ``csrc/ssd_scan.cu`` compiles in."""
    import re
    from pathlib import Path

    from repro_torch.kernels.ssd_scan.ssd_scan import LIMITS

    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/ssd_scan.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (QM|NM|PM) = (\d+);", src)}
    assert LIMITS == (consts["QM"], consts["NM"], consts["PM"])


def test_plain_scan_keeps_float64_inputs_in_float64():
    """float64 inputs are scanned in float64 (a float64 model is the
    reference for the float32 sums): equal to the token-by-token recurrence
    h_t = exp(dt_t A) h_(t-1) + dt_t x_t B_t^T, y_t = h_t C_t in numpy
    float64 to 1e-12, where the float32 scan is ~1e-6 away; the gradient is
    float64 too."""
    x, dt, A, B, C = (a.astype(np.float64) for a in _inputs(11, 2, 32, 3, 4, 5))
    h = np.zeros((2, 3, 5, 4))
    want = np.zeros_like(x)
    for t in range(x.shape[1]):
        h = (np.exp(dt[:, t] * A)[:, :, None, None] * h
             + np.einsum("bh,bn,bhp->bhnp", dt[:, t], B[:, t], x[:, t]))
        want[:, t] = np.einsum("bhnp,bn->bhp", h, C[:, t])
    ins64 = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y64 = ssd_scan_ref(*ins64, 8)
    y32 = ssd_scan_ref(*(t.detach().float() for t in ins64), 8)
    assert y64.dtype == torch.float64
    assert np.abs(y64.detach().numpy() - want).max() <= 1e-12 * np.abs(want).max()
    assert np.abs(y32.double().numpy() - want).max() >= 1e-9 * np.abs(want).max()
    grads = torch.autograd.grad(y64.sum(), ins64)
    assert all(g.dtype == torch.float64 for g in grads)
