"""Plain PyTorch version of the decode-attention kernel.

Follows ``repro/kernels/decode_attention/ref.py``: GQA by repeating each KV
head ``rep`` times, fp32 logits scaled by ``1/sqrt(D)``, keys at or past
``lengths`` masked with -1e30, softmax, output in q's dtype.
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
