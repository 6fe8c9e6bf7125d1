"""Plain PyTorch versions of the SSD scan and its gradient.

``ssd_scan_ref`` is the chunked state-space-dual scan of
``repro.models.ssm.ssd_chunked`` (the function ``ssd_scan_pallas`` computes)
without the D term, in float32 throughout (float64 for float64 inputs, so
that a float64 model is a reference for float32 sums): unlike
``ssd_chunked`` it does not round the scores or the carried states to the
input's type.  CPU
tensors take these in :mod:`.ssd_scan`; on the card they are what the
kernels are held against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _chunk(s: int, chunk: int) -> int:
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    return chunk


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int = 128,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (Bt, S, H, P), dt (Bt, S, H), A (H,), B/C (Bt, S, N) -> y (Bt, S, H, P)
    in ``out_dtype`` (default x's), computed in float32 (float64 for float64
    x) over chunks of ``min(chunk, S)`` rows."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    q = _chunk(s, chunk)
    nc = s // q
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xb = x.to(acc).reshape(bt, nc, q, h, p)
    dtb = dt.to(acc).reshape(bt, nc, q, h)
    Bb = B.to(acc).reshape(bt, nc, q, n)
    Cb = C.to(acc).reshape(bt, nc, q, n)

    cs = torch.cumsum(dtb * A.to(acc), dim=2)                  # (Bt, nc, Q, H)
    total = cs[:, :, -1]                                       # (Bt, nc, H)
    scores = torch.einsum("bcin,bcjn->bcij", Cb, Bb)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (Bt, nc, Q, Q, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask the exponent, not the product: exp of the upper triangle overflows
    l_mat = torch.exp(torch.where(causal[:, :, None], seg, torch.full_like(seg, -1e30)))
    xbar = xb * dtb[..., None]                                 # (Bt, nc, Q, H, P)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * l_mat, xbar)

    decay_end = torch.exp(total[:, :, None, :] - cs)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bb, decay_end, xbar)
    chunk_decay = torch.exp(total)
    st = torch.zeros((bt, h, n, p), dtype=acc, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (Bt, nc, H, N, P)
    y = y + torch.einsum("bcin,bchnp,bcih->bcihp", Cb, prev_states, torch.exp(cs))
    return y.reshape(bt, s, h, p).to(out_dtype or x.dtype)


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                     C: torch.Tensor, dy: torch.Tensor, chunk: int = 128
                     ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC), each in its input's dtype, for the output
    gradient ``dy`` (whose dtype is the output's): autograd through
    :func:`ssd_scan_ref`."""
    ins = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
    with torch.enable_grad():
        y = ssd_scan_ref(*ins, chunk=chunk, out_dtype=dy.dtype)
        return torch.autograd.grad(y, ins, dy)
