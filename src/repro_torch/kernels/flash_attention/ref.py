"""Plain PyTorch versions of the flash-attention kernels.

``flash_attention_fwd_ref`` is a blockwise port of ``_flash_fwd_impl`` and
``flash_attention_bwd_ref`` of ``_flash_vjp_bwd`` (both in
``repro/models/layers.py``), with the mask of ``_flash_mask`` written out
in torch.  GQA uses the grouped layout (B, Hkv, rep, ...), the softmax
state m/l/acc is float32 (float64 for float64 inputs, so that
``torch.autograd.gradcheck`` can run on them), and masked scores take the
finite sentinel -1e30: in a live block where every key of a row is masked,
``exp(s - m)`` is then 1, not NaN, and a later ``alpha = 0`` wipes it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def flash_mask(sq: int, block: int, sk: int, kv_i: int, q_pos: torch.Tensor, *,
               causal: bool, window: int, chunk: int,
               prefix_len: int) -> torch.Tensor:
    """(Sq, block) validity of KV block ``kv_i`` for queries at ``q_pos``."""
    kv_pos = kv_i * block + torch.arange(block, device=q_pos.device)
    mask = (kv_pos < sk)[None, :].expand(sq, block)
    if causal:
        cm = q_pos[:, None] >= kv_pos[None, :]
        if prefix_len:
            cm = cm | (kv_pos[None, :] < prefix_len)
        mask = mask & cm
    if window:
        mask = mask & ((q_pos[:, None] - kv_pos[None, :]) < window)
    if chunk:
        mask = mask & (torch.div(q_pos[:, None], chunk, rounding_mode="floor")
                       == torch.div(kv_pos[None, :], chunk, rounding_mode="floor"))
    return mask


def _blocks(x: torch.Tensor, block: int, acc: torch.dtype):
    """(B, Sk, Hkv, D) -> list of (B, Hkv, block, D) blocks, zero-padded."""
    sk = x.shape[1]
    pad = -(-sk // block) * block - sk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    return [blk.to(acc).transpose(1, 2) for blk in x.split(block, dim=1)]


def _grouped(x: torch.Tensor, hkv: int, acc: torch.dtype) -> torch.Tensor:
    """(B, Sq, Hq, D) -> (B, Hkv, rep, Sq, D) in ``acc``."""
    b, sq, hq, d = x.shape
    return x.to(acc).reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int = 0, chunk: int = 0,
                            prefix_len: int = 0, q_offset: int = 0,
                            block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> out (B, Sq, Hq, D) in q's
    dtype and lse (B, Hq, Sq), the log-sum-exp of each row's scaled scores."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    acc_t = _acc_dtype(q)
    scale = 1.0 / math.sqrt(d)
    qt = _grouped(q * scale, hkv, acc_t)                     # (B,Hkv,rep,Sq,D)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    shape = qt.shape[:-1]
    m = torch.full(shape, NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros(shape, dtype=acc_t, device=q.device)
    acc = torch.zeros(qt.shape, dtype=acc_t, device=q.device)
    for i, (kb, vb) in enumerate(zip(_blocks(k, block, acc_t), _blocks(v, block, acc_t))):
        s = torch.einsum("bgrqd,bgkd->bgrqk", qt, kb)
        mask = flash_mask(sq, block, sk, i, q_pos, causal=causal, window=window,
                          chunk=chunk, prefix_len=prefix_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p, vb)
        m = m_new
    lmax = torch.clamp_min(l, 1e-30)
    out = acc / lmax[..., None]
    lse = m + torch.log(lmax)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return out, lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                            causal: bool = True, window: int = 0, chunk: int = 0,
                            prefix_len: int = 0, q_offset: int = 0,
                            block: int = 512) -> Tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of the attention output against ``g``: the KV
    blocks are scanned again and the scores recomputed from (q, k, lse)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    acc_t = _acc_dtype(q)
    scale = 1.0 / math.sqrt(d)
    qt, gt, ot = (_grouped(x, hkv, acc_t) for x in (q, g, out))
    delta = torch.sum(gt * ot, dim=-1)                       # (B,Hkv,rep,Sq)
    lse_g = lse.to(acc_t).reshape(delta.shape)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros(qt.shape, dtype=acc_t, device=q.device)
    dks, dvs = [], []
    for i, (kb, vb) in enumerate(zip(_blocks(k, block, acc_t), _blocks(v, block, acc_t))):
        s = torch.einsum("bgrqd,bgkd->bgrqk", qt * scale, kb)
        mask = flash_mask(sq, block, sk, i, q_pos, causal=causal, window=window,
                          chunk=chunk, prefix_len=prefix_len)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse_g[..., None])                  # (B,Kv,rep,Sq,blk)
        dvs.append(torch.einsum("bgrqk,bgrqd->bgkd", p, gt))
        dp = torch.einsum("bgrqd,bgkd->bgrqk", gt, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bgrqk,bgkd->bgrqd", ds, kb)
        dks.append(torch.einsum("bgrqk,bgrqd->bgkd", ds, qt))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    dk = torch.cat(dks, dim=2)[:, :, :sk].transpose(1, 2).to(k.dtype)
    dv = torch.cat(dvs, dim=2)[:, :, :sk].transpose(1, 2).to(v.dtype)
    return dq, dk, dv
