"""Neural building blocks of the model: plain functions on tensors.

Counterparts of ``repro/models/layers.py`` with the same arithmetic and the
same casts: norms and RoPE compute in float32 and cast back to the input
dtype, projections run in the dtype jnp promotes ``x @ w`` to
(:func:`matmul`).  Parameters arrive as mappings of tensors (an
``nn.ParameterDict`` in the model).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    decode_attention_cache_ref as decode_attention_cache)
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.parallel.collectives import pmax, psum

Params = Mapping[str, torch.Tensor]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype, as jnp computes it: float32
    activations (an encoder over float32 frames) with bf16 weights give a
    float32 product, where ``torch.matmul`` refuses mixed dtypes."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# ------------------------------------------------------------------ norms

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def norm(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def init_norm(d: int, kind: str, device, dtype=torch.float32) -> dict:
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


# ------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S).  Non-interleaved halves."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------- flash attention

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    prefix_len: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention (train/prefill), the counterpart of
    ``flash_attention_xla``: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), GQA via
    Hq // Hkv.  ``window`` > 0 = sliding window; ``chunk`` > 0 =
    chunk-local; ``prefix_len`` > 0 = prefix-LM.  Differentiable; on CUDA
    tensors the forward and the backward run the flash-attention kernels
    (:mod:`repro_torch.kernels.flash_attention`).

    A bf16 q over float32 k/v (a decoder's cross-attention to a float32
    encoder) runs in float32 and returns q's dtype, as the JAX function
    does: it computes every block in float32 and casts the output to q's
    dtype.  JAX scales q in its own dtype first; for the power-of-two
    scales of head dims 16, 64 and 256 that rounds nothing."""
    dt = torch.promote_types(q.dtype, k.dtype)
    out = _flash_kernel(q.to(dt), k.to(dt), v.to(dt), causal=causal, window=window,
                        chunk=chunk, prefix_len=prefix_len, q_offset=q_offset)
    return out.to(q.dtype)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, axis, dtype) -> torch.Tensor:
    """One-token attention over a cache split over the ranks of ``axis``
    (an :class:`~repro_torch.parallel.mesh.Axis`): each rank's float32
    output (B, 1, Hq, D) over its own slots and their log-sum-exp (B, Hq),
    as ``decode_attention_cache(..., return_lse=True)`` gives them, merged
    into the softmax over every rank's slots: M = pmax(lse), w = exp(lse -
    M), out = psum(w out) / psum(w) (one all-reduce of both), in float32,
    cast to ``dtype`` once.  A rank whose row holds no valid slot (lse -inf,
    or -1e30 + log W from the plain version) weighs 0; some rank holds the
    query's own slot, so M is finite."""
    m = pmax(lse, axis)
    w = torch.exp(lse - m)                                       # (B, Hq)
    both = psum(torch.cat([out[:, 0] * w[..., None], w[..., None]], dim=-1), axis)
    return (both[..., :-1] / both[..., -1:]).to(dtype)[:, None]


# --------------------------------------------------------------- dense mlp

def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        g = matmul(x, p["w_gate"])
        u = matmul(x, p["w_up"])
        h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    else:
        h = F.gelu(matmul(x, p["w_up"]), approximate="tanh")
    return matmul(h, p["w_down"])


def init_mlp(generator: torch.Generator, d: int, f: int, act: str,
             device, dtype=torch.bfloat16) -> dict:
    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dtype)

    s_in = 1.0 / math.sqrt(d)
    s_ff = 1.0 / math.sqrt(f)
    p = {"w_up": normal((d, f), s_in), "w_down": normal((f, d), s_ff)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal((d, f), s_in)
    return p
