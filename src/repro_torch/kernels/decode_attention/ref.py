"""Plain PyTorch versions of the decode-attention kernel's two masks.

``decode_attention_ref`` follows ``repro/kernels/decode_attention/ref.py``:
GQA by repeating each KV head ``rep`` times, fp32 logits scaled by
``1/sqrt(D)``, keys at or past ``lengths`` masked with -1e30, softmax,
output in q's dtype.  ``decode_attention_cache_ref`` follows
``decode_attention_cache_xla`` in ``repro/models/layers.py``: the same
attention against a ring-buffer cache whose slots carry absolute positions.
"""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) valid entries."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    rep = hq // hkv
    k = torch.repeat_interleave(k_cache, rep, dim=2) if rep > 1 else k_cache
    v = torch.repeat_interleave(v_cache, rep, dim=2) if rep > 1 else v_cache
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) / math.sqrt(d)
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    logits = logits.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v.float()).to(q.dtype)


def slot_mask(slot_pos: torch.Tensor, q_pos: torch.Tensor, window: int = 0,
              chunk: int = 0) -> torch.Tensor:
    """(B, W) bool: the slots a query at ``q_pos`` attends to.  A slot is
    valid when it holds a position (>= 0) not after the query's, within
    ``window`` positions of it (``window`` > 0) and in its chunk
    (``chunk`` > 0)."""
    qp = q_pos.to(slot_pos.device)[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= qp)
    if window:
        valid &= (qp - slot_pos) < window
    if chunk:
        valid &= torch.div(slot_pos, chunk, rounding_mode="floor") == \
            torch.div(qp, chunk, rounding_mode="floor")
    return valid


def decode_attention_cache_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, slot_pos: torch.Tensor,
                               q_pos: torch.Tensor, *, window: int = 0,
                               chunk: int = 0, return_lse: bool = False):
    """Single-token attention against a ring-buffer cache with per-slot
    absolute positions.

    q: (B, 1, Hq, D); caches: (B, W, Hkv, D); slot_pos: (B, W) absolute
    position stored in each slot (-1 = empty); q_pos: (B,).  Returns
    (B, 1, Hq, D) in q's dtype; with ``return_lse`` the float32 output and
    each row's (B, Hq) float32 log-sum-exp of its masked logits, which for
    a row with no valid slot is -1e30 + log W (the mask's value) beside the
    mean of V.
    """
    b, _, hq, d = q.shape
    _, w, hkv, _ = k_cache.shape
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qh = (q[:, 0].float() * scale).reshape(b, hkv, rep, d)
    s_logits = torch.einsum("bgrd,bsgd->bgrs", qh, k_cache.float())
    valid = slot_mask(slot_pos, q_pos, window, chunk)
    s_logits = s_logits.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(s_logits, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.float()).reshape(b, 1, hq, d)
    if return_lse:
        return out, torch.logsumexp(s_logits, dim=-1).reshape(b, hq)
    return out.to(q.dtype)
