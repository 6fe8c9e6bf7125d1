"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py`` with the same arithmetic and the same
casts.  The chunked scan of the training forward, :func:`ssd_chunked`, runs
the hand-written SSD-scan kernels on the card, forward and backward
(:mod:`repro_torch.kernels.ssd_scan`); one-token decode is the plain
recurrence :func:`ssd_decode_step`, as in JAX, where it is no kernel either.
Projections stay separate (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``) with the
JAX shapes, so ``x @ w`` reads the same in both packages.

Under a model axis (``axis`` of :func:`ssd_block_apply`) the block holds
this rank's share, as ``repro``'s specs shard it: ``w_z``, ``w_x``, the x
conv, ``norm_scale`` and the rows of ``out_proj`` over ``ff`` (``d_inner``),
``w_dt``, ``A_log``, ``D`` and ``dt_bias`` over ``heads``, and ``w_B``,
``w_C`` and their convs replicated.  The scan runs on the rank's heads; the
gated norm's mean square is the sum of squares summed over the axis over
the full ``d_inner``; the output is a partial sum over the axis, which the
caller reduces.  Decode advances the rank's heads' state alone.  Each rank's B/C leaves see only its heads, so they enter
through *f* (their gradients are summed over the axis).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.parallel.collectives import copy_to, psum

Params = Mapping[str, torch.Tensor]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked state-space-dual scan, differentiable.

    x (Bt, S, H, P); dt (Bt, S, H) positive float32; A (H,) negative
    float32; B/C (Bt, S, N), one group broadcast over the heads.  Returns y
    (Bt, S, H, P) in float32, the type JAX's einsums promote to (dt is
    float32).  Unlike JAX, the scores and the carried states are not rounded
    to x's type in between."""
    s = x.shape[1]
    if s % chunk:
        raise ValueError(f"seq {s} must be a multiple of the chunk size {chunk}")
    return ssd_scan(x, dt, A, B, C, chunk=chunk, out_dtype=torch.float32)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  state (Bt, H, N, P); x (Bt, H, P);
    dt (Bt, H); B/C (Bt, N).  Returns (y (Bt, H, P), new state)."""
    dec = torch.exp(dt * A)                                  # (Bt, H)
    add = torch.einsum("bn,bh,bhp->bhnp", B, dt, x)
    new_state = state * dec[:, :, None, None] + add
    y = torch.einsum("bn,bhnp->bhp", C, new_state)
    return y, new_state


# ------------------------------------------------------------- full block


def init_ssd_block(generator: torch.Generator, cfg, device,
                   dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights with the shapes and scales of ``repro``'s
    ``init_ssd_block``, each drawn from ``generator`` in turn (JAX draws
    ``conv_B_w``/``conv_C_w`` and ``w_z``/``out_proj`` from one key each;
    see ROADMAP.md § 3).  A_log, D, dt_bias and norm_scale are float32."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def zeros(width, dt=dtype):
        return torch.zeros((width,), dtype=dt, device=device)

    s_in = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "w_z": normal((d, di), s_in),
        "w_x": normal((d, di), s_in),
        "w_B": normal((d, n), s_in),
        "w_C": normal((d, n), s_in),
        "w_dt": normal((d, h), s_in),
        "conv_x_w": normal((cfg.conv_width, di), 0.2),
        "conv_x_b": zeros(di),
        "conv_B_w": normal((cfg.conv_width, n), 0.2),
        "conv_B_b": zeros(n),
        "conv_C_w": normal((cfg.conv_width, n), 0.2),
        "conv_C_b": zeros(n),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device)),
        "D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": zeros(h, f32),
        "norm_scale": zeros(di, f32),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (Bt, S, Ch) with kernel (W, Ch), then
    SiLU.  Returns the output and the last W - 1 inputs (the next cache)."""
    width = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = cache
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width)) + b
    return F.silu(out), xp[:, -(width - 1):]


_REPLICATED = ("w_B", "w_C", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b")


def ssd_block_apply(p: Params, cfg, x: torch.Tensor,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    decode: bool = False, axis=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (Bt, S, d) -> (Bt, S, d) and, when ``decode``, the new cache
    ``{state, conv_x, conv_B, conv_C}`` (else None).  Under a model axis
    ``axis`` (an :class:`~repro_torch.parallel.mesh.Axis`) p holds this
    rank's shards and the output is this rank's partial sum (module
    docstring); in decode the cache holds this rank's share too (its heads'
    state and its channels' x conv; the B/C convs whole), and each head's
    state advances alone."""
    hd = cfg.ssm_head_dim
    di, h = p["w_x"].shape[-1], p["w_dt"].shape[-1]        # this rank's share
    if di != h * hd:
        raise ValueError(f"{di} inner channels do not hold {h} heads of {hd}")
    if axis is not None and axis.size > 1:
        p = {k: copy_to(v, axis) if k in _REPLICATED else v for k, v in p.items()}
    else:
        axis = None
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    B_raw = x @ p["w_B"]
    C_raw = x @ p["w_C"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    new_cache: Dict[str, torch.Tensor] = {}
    cx = cache.get("conv_x") if cache else None
    cB = cache.get("conv_B") if cache else None
    cC = cache.get("conv_C") if cache else None
    xs, new_cache["conv_x"] = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"], cx)
    B, new_cache["conv_B"] = _causal_conv(B_raw, p["conv_B_w"], p["conv_B_b"], cB)
    C, new_cache["conv_C"] = _causal_conv(C_raw, p["conv_C_w"], p["conv_C_b"], cC)

    if decode:
        xh = xs[:, 0].reshape(-1, h, hd)
        y, new_cache["state"] = ssd_decode_step(
            cache["state"].float(), xh.float(), dt[:, 0], A, B[:, 0].float(), C[:, 0].float())
        y = y + p["D"][:, None] * xh.float()
        y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    else:
        xh = xs.reshape(xs.shape[0], xs.shape[1], h, hd)
        y = ssd_chunked(xh, dt, A, B, C, cfg.ssm_chunk)
        y = y + p["D"][None, None, :, None] * xh
        y = y.reshape(x.shape[0], x.shape[1], di)
        new_cache = None

    # gated RMSNorm (Mamba-2), in float32; under a model axis the squares of
    # every rank's channels (the sum's gradient reaches every rank's share)
    g = y * F.silu(z)
    g32 = g.float()
    if axis is None:
        var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    else:
        sq = torch.sum(g32 * g32, dim=-1, keepdim=True)
        var = copy_to(psum(sq, axis), axis) / cfg.d_inner
    g = (g32 * torch.rsqrt(var + 1e-6) * (1 + p["norm_scale"])).to(x.dtype)
    return g @ p["out_proj"], new_cache


def init_ssd_cache(cfg, batch: int, dtype=torch.bfloat16, device="cuda",
                   p: Optional[Params] = None) -> Dict[str, torch.Tensor]:
    """Zeroed decode state: the (Bt, H, N, P) SSD state in float32 (JAX
    starts it in ``dtype`` and keeps it in float32 from the first step on;
    the zeros are the same) and the conv caches (Bt, W - 1, Ch) in ``dtype``.
    Given the block's weights ``p``, H and the x conv's channels are those
    of its shares (this rank's under a mesh)."""
    w = cfg.conv_width - 1
    heads = cfg.ssm_heads if p is None else p["w_dt"].shape[-1]
    inner = cfg.d_inner if p is None else p["w_x"].shape[-1]
    return {
        "state": torch.zeros((batch, heads, cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, w, inner), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w, cfg.ssm_state), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w, cfg.ssm_state), dtype=dtype, device=device),
    }
