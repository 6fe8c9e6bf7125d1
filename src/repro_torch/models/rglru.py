"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py`` with the same arithmetic and the
same casts: a gate branch ``gelu(x W_gate)``, a recurrent branch ``x W_x``
through a causal depthwise conv, the Real-Gated LRU recurrence

    r_t = sigmoid(x W_r + b_r)          (recurrence gate)
    i_t = sigmoid(x W_i + b_i)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

in float32, then the gated output projection.  As in ``repro``, the gates
read the block input, not the conv output.

Training evaluates the recurrence with :func:`lru_scan`, a log-depth
doubling scan over the sequence with a hand-written backward (the reverse
recurrence run through the same scan); ``repro``'s ``_lru_scan`` is a
``lax.associative_scan``, not a Pallas kernel, so the port's is torch code.
Decode is the plain one-step update, whose new state is stored in the
activations' dtype, as in ``repro``.

Under a model axis the block holds this rank's share of the recurrence
width, as ``repro``'s specs shard it over ``ff``: the columns of ``w_gate``,
``w_x``, ``w_r`` and ``w_i``, the biases, ``lam``, the conv and the rows of
``w_out``.  The recurrence is per channel, so it needs no communication;
the output is this rank's partial sum, which the caller reduces.  Decode
is elementwise over the channels too: the rank's ``h`` and conv cache
advance alone.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]

C_FACTOR = 8.0


def init_rglru_block(generator: torch.Generator, cfg, device,
                     dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights with the shapes and scales of ``repro``'s
    ``init_rglru_block``, each drawn from ``generator`` in turn.  ``b_r``,
    ``b_i`` and ``lam`` are float32; ``lam`` is the reference's closed form,
    which spreads a^c over (0.9, 0.999)."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    f32 = torch.float32

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    s = 1.0 / math.sqrt(d)
    p = {"w_x": normal((d, w), s), "w_gate": normal((d, w), s),
         "w_r": normal((d, w), s), "w_i": normal((d, w), s)}
    p["b_r"] = torch.zeros((w,), dtype=f32, device=device)
    p["b_i"] = torch.zeros((w,), dtype=f32, device=device)
    p["lam"] = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, w, dtype=f32, device=device)) / C_FACTOR))
    p["conv_w"] = normal((cfg.conv_width, w), 0.2)
    p["conv_b"] = torch.zeros((w,), dtype=dtype, device=device)
    p["w_out"] = normal((w, d), 1.0 / math.sqrt(w))
    return p


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 with h_{-1} = 0: log2(S) passes,
    each combining every element with the one ``2^k`` before it."""
    s = a.shape[1]
    step = 1
    while step < s:
        b = torch.cat([b[:, :step], torch.addcmul(b[:, step:], a[:, step:], b[:, :-step])], 1)
        if 2 * step < s:
            a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], 1)
        step *= 2
    return b


class _LruScan(torch.autograd.Function):
    """h = scan(a, bx) with the carry-in folded into the first step.  The
    backward is the reverse recurrence g_t = dh_t + a_{t+1} g_{t+1}, run
    through the same scan on the reversed sequence: dbx = g, da_t = g_t
    h_{t-1} (h_{-1} = h0, or 0), dh0 = a_0 g_0.  Only a, h and h0 are
    saved."""

    @staticmethod
    def forward(ctx, a, bx, h0):
        if h0 is not None:
            bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
        h = _doubling_scan(a, bx)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        with torch.profiler.record_function("rglru.scan"):
            a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
            g = _doubling_scan(a_next.flip(1), dh.flip(1)).flip(1)
            first = h0[:, None] if h0 is not None else torch.zeros_like(h[:, :1])
            da = g * torch.cat([first, h[:, :-1]], 1)
            dh0 = a[:, 0] * g[:, 0] if h0 is not None else None
        return da, g, dh0


def lru_scan(a: torch.Tensor, bx: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + bx_t over S, differentiable.  a, bx: (Bt, S, W)
    float32; h0 (Bt, W) or None.  Returns (h (Bt, S, W), final h).  The
    sums run in another order than ``lax.associative_scan``'s, so the
    results agree to float32 rounding, not bit for bit.  Forward and
    backward run under the profiler range ``rglru.scan``."""
    with torch.profiler.record_function("rglru.scan"):
        h = _LruScan.apply(a, bx, h0)
    return h, h[:, -1]


def rglru_block_apply(p: Params, cfg, x: torch.Tensor,
                      cache: Optional[Dict[str, torch.Tensor]] = None,
                      decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (Bt, S, d) -> (Bt, S, d) and, when ``decode``, the new cache
    ``{h, conv}`` (else None)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xb = x @ p["w_x"]

    # causal depthwise conv on the recurrent branch: the shifted products
    # summed in the activations' dtype, in the reference's order
    width = p["conv_w"].shape[0]
    if decode:
        pad = cache["conv"]
    else:
        pad = torch.zeros((xb.shape[0], width - 1, xb.shape[2]), dtype=xb.dtype,
                          device=xb.device)
    padded = torch.cat([pad, xb], dim=1)
    new_conv = padded[:, -(width - 1):]
    xc = sum(padded[:, i:i + xb.shape[1]] * p["conv_w"][i] for i in range(width)) + p["conv_b"]

    r = torch.sigmoid((x @ p["w_r"]).float() + p["b_r"])
    i = torch.sigmoid((x @ p["w_i"]).float() + p["b_i"])
    log_a = -C_FACTOR * F.softplus(p["lam"]) * r                  # (Bt, S, W)
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.float())

    if decode:
        h = a[:, 0] * cache["h"].float() + gated_in[:, 0]
        hs = h[:, None]
        new_cache = {"h": h.to(x.dtype), "conv": new_conv}
    else:
        hs, _ = lru_scan(a, gated_in)
        new_cache = None
    return (hs.to(x.dtype) * gate) @ p["w_out"], new_cache


def init_rglru_cache(cfg, batch: int, dtype=torch.bfloat16, device="cuda",
                     p: Optional[Params] = None) -> Dict[str, torch.Tensor]:
    """Zeroed decode state: ``h`` (Bt, W) and the conv cache ``conv``
    (Bt, conv_width - 1, W), both in ``dtype`` as in ``repro``.  Given the
    block's weights ``p``, W is their share of the width (this rank's
    under a mesh)."""
    w = (cfg.rnn_width or cfg.d_model) if p is None else p["lam"].shape[-1]
    return {"h": torch.zeros((batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device)}
