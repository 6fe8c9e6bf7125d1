"""Wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, ...)`` is differentiable: a
``torch.autograd.Function`` whose forward runs :func:`flash_attention_fwd`
and saves ``(q, k, v, out, lse)``, and whose backward runs
:func:`flash_attention_bwd`.  Together they compute what
``repro.kernels.flash_attention.flash_attention_pallas`` and the custom VJP
of ``repro.models.layers.flash_attention_xla`` compute.  On CPU tensors
each runs its plain version (:mod:`.ref`); on CUDA tensors it launches the
kernels, or raises when they do not take the inputs; on ``meta`` tensors
(the dry run) it checks them as for the card and returns empty outputs of
the kernels' shapes and dtypes, launching nothing.  On every device each
call reports the kernel's work to a running op-level analysis through
:mod:`repro_torch.obs.op_counts` (:func:`work`: FLOPs
over the (query, key) pairs the mask keeps, the bytes each tensor moves
once, an exponential a pair).  Tensors keep the JAX
layout (B, S, H, D); the kernels read their strides, so no transposed copy
is made.  ``flash_attention.launches`` counts forward launches and
``flash_attention_bwd.launches`` backward calls (each launches the delta
pre-pass, the dK/dV kernel with its reduction, and the dQ kernel).

For bfloat16 (any D up to 256) the kernels load their tiles with TMA and
multiply on the tensor cores with ``wgmma``.  float32 runs on the tensor
cores too, as 3xTF32 ``mma.sync`` products (each operand split into two
TF32 halves, three products summed, float32's accuracy), from tiles loaded
with ``cp.async`` through the tensors' strides.
The host-side plan of the TMA loads (:func:`tensor_map_spec`,
:func:`tensor_maps`, :func:`tile_rows`) and of the fp32 dK/dV scratch
(:func:`dkv_partial_shape`) is plain Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from ...obs import op_counts as A
from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

SMEM_LIMIT = 232448          # bytes of shared memory a block may use on Hopper
_DTYPES = (torch.float32, torch.bfloat16)
FWD, DKDV, DQ, DELTA = 0, 1, 2, 3    # kernel kinds of the C entry point
# Rows of one tile load (query side, key side) of each Hopper kernel, by
# the tile width DMAX (64, 128 or 256); the C side refuses a tensor map
# whose box differs from its tile.  At DMAX 256 the streamed tiles shrink
# so that the shared-memory ring fits (FwdTile, DkdvTile, DqTile in
# csrc/flash_attention.cu).
_NARROW_ROWS = {FWD: (128, 128), DKDV: (64, 64), DQ: (128, 64)}
TILE_ROWS = {64: _NARROW_ROWS, 128: _NARROW_ROWS,
             256: {FWD: (128, 64), DKDV: (64, 64), DQ: (128, 32)}}
TMA_BOX_COLS = 64            # 128 bytes of bf16: the 128-byte swizzle's row
MAP_SPEC_LEN = 11            # values of one tensor-map plan
_TMA_ERRORS = {1001: "libcuda has no cuTensorMapEncodeTiled",
               1002: "cuTensorMapEncodeTiled refused a tensor map",
               1003: "a tensor map's box does not match the kernel's tile"}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def smem_bytes(kind: int, d: int, bf16: bool) -> int:
    """Shared memory one block of kernel ``kind`` needs at head dim ``d``."""
    return _lib().flash_attention_smem_bytes(kind, d, int(bf16))


def uses_tensor_maps(dtype: torch.dtype, d: int) -> bool:
    """True where the TMA and wgmma kernels run: bf16 at every head dim the
    kernels take (up to 256); float32 takes the 3xTF32 kernels, which load
    through pointers and need no tensor map."""
    return dtype == torch.bfloat16 and d <= 256


def dmax(d: int) -> int:
    """The tile width of head dim ``d``: 64, 128 or 256 columns, each row
    loaded as ``dmax(d) // TMA_BOX_COLS`` boxes; columns past ``d`` read
    as zeros."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def tile_rows(kind: int, d: int) -> Tuple[int, int]:
    """(query-side, key-side) rows of one tile load of kernel ``kind``."""
    return TILE_ROWS[dmax(d)][kind]


def tensor_map_spec(shape, stride, elem_size: int, rows: int) -> list:
    """The plan of one TMA tensor map over a (B, S, H, D) tensor with element
    ``stride``: dims innermost first {D, H, S, B}, the byte strides of H, S
    and B, and a box of 64 columns x 1 head x ``rows`` rows x 1 batch."""
    b, s, h, d = shape
    sb, ss, sh, _ = stride
    return [d, h, s, b, sh * elem_size, ss * elem_size, sb * elem_size,
            TMA_BOX_COLS, 1, rows, 1]


def tensor_maps(kind: int, q, k, v, g=None) -> list:
    """Plans of the maps of q, k, v and g (zeros where g is None) for
    kernel ``kind``, ``MAP_SPEC_LEN`` values each."""
    q_rows, k_rows = tile_rows(kind, q.shape[-1])
    spec = []
    for t, rows in ((q, q_rows), (k, k_rows), (v, k_rows), (g, q_rows)):
        spec += ([0] * MAP_SPEC_LEN if t is None else
                 tensor_map_spec(t.shape, t.stride(), t.element_size(), rows))
    return spec


def dkv_partial_shape(b: int, sk: int, hq: int, d: int) -> Tuple[int, ...]:
    """fp32 scratch of the Hopper dK/dV kernel: dK and dV of every query
    head, (2, B, Sk, Hq, D), summed over each KV group by the reduction."""
    return (2, b, sk, hq, d)


def _check(q, k, v, *extra):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, Hq, D) and k/v (B, Sk, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    bk, _, hkv, dk = k.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d}: the kernels take multiples of 8 up to 256")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence: the kernels take Sq, Sk >= 1")
    tensors = (q, k, v, *extra)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"dtypes {[t.dtype for t in tensors]}: the kernels take "
                        f"float32 or bfloat16, the same for q, k, v and the gradient")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    vec = 16 // q.element_size()              # the kernels load 16 bytes at a time
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("the last dimension of q, k, v and the gradient must "
                             "be contiguous")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1]):
            raise ValueError("rows must start on 16-byte boundaries")
        if uses_tensor_maps(q.dtype, d) and any(
                st == 0 and n > 1 for st, n in zip(t.stride()[:-1], t.shape[:-1])):
            raise ValueError("broadcast (stride 0) dimensions: the tensor maps of "
                             "the bf16 kernels need a distinct row for every index")


def _launch(kind, ptrs, tensors, shape, mask, bf16, scale, device, maps=None):
    need = smem_bytes(kind, shape[-1], bf16)
    if need > SMEM_LIMIT:
        raise ValueError(f"head dim {shape[-1]} needs {need} bytes of shared memory, "
                         f"more than {SMEM_LIMIT}")
    strides = []
    for t in tensors:
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    c_ptrs = (ctypes.c_void_p * 12)(*ptrs, *[None] * (12 - len(ptrs)))
    c_maps = None if maps is None else (ctypes.c_longlong * len(maps))(*maps)
    c_strides = (ctypes.c_longlong * 24)(*strides)
    c_shape = (ctypes.c_int * 6)(*shape)
    c_mask = (ctypes.c_int * 5)(*mask)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().flash_attention_launch(kind, c_ptrs, c_strides, c_shape, c_mask,
                                        int(bf16), scale, c_maps, stream)
    if err:
        name = {FWD: "forward", DKDV: "dK/dV", DQ: "dQ", DELTA: "delta"}[kind]
        why = _TMA_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {name} kernel launch failed: {why}")


def _mask_args(causal, window, chunk, prefix_len, q_offset):
    if min(window, chunk, prefix_len, q_offset) < 0:
        raise ValueError("window, chunk, prefix_len and q_offset must be >= 0")
    return [int(bool(causal)), int(window), int(chunk), int(prefix_len), int(q_offset)]


def _on(t: torch.Tensor, name: str) -> bool:
    """True for CUDA tensors (the kernels), False for CPU ones (the plain
    version) and meta ones (shapes only)."""
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} runs on cpu, cuda or meta, not {t.device}")
    return t.device.type == "cuda"


@functools.lru_cache(maxsize=1024)
def kept_pairs(sq: int, sk: int, causal: bool, window: int, chunk: int, prefix_len: int,
               q_offset: int) -> int:
    """The (query, key) pairs of one head that the mask keeps: keys at or
    before the query (or in the prefix) when causal, fewer than ``window``
    positions back, in the query's chunk."""
    q = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.zeros(sq, dtype=np.int64)
    hi = np.full(sq, sk - 1, dtype=np.int64)
    if window:
        lo = np.maximum(lo, q - window + 1)
    if chunk:
        start = q // chunk * chunk
        lo, hi = np.maximum(lo, start), np.minimum(hi, start + chunk - 1)
    if causal:
        hi = np.minimum(hi, np.maximum(q, prefix_len - 1))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def work(q: torch.Tensor, k: torch.Tensor, backward: bool, causal: bool = True,
         window: int = 0, chunk: int = 0, prefix_len: int = 0,
         q_offset: int = 0) -> Tuple[int, int, int]:
    """(FLOPs, bytes, exponentials) of one forward or backward call: the
    forward 4 D FLOPs a kept pair and head (scores and values), reading q,
    k, v and writing the output and lse; the backward 10 D (the scores
    recomputed, dV, dP, dQ, dK), reading q, k, v, the output, its gradient
    and lse and writing dq, dk, dv; one exponential a kept pair either
    way."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pairs = b * hq * kept_pairs(sq, sk, bool(causal), int(window), int(chunk),
                                int(prefix_len), int(q_offset))
    qo = q.element_size() * b * sq * hq * d
    kv = k.element_size() * b * sk * hkv * d
    rows = 4 * b * hq * sq
    if backward:
        return 10 * pairs * d, 4 * qo + 4 * kv + rows, pairs
    return 4 * pairs * d, 2 * qo + 2 * kv + rows, pairs


def _report(name, q, k, backward, outputs, **kw):
    flops, nbytes, exps = work(q, k, backward, **kw)
    A.report_kernel(name, flops=flops, nbytes=nbytes, transcendentals=exps, outputs=outputs)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, chunk: int = 0,
                        prefix_len: int = 0,
                        q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> out (B, Sq, Hq, D) in q's
    dtype and lse (B, Hq, Sq) float32."""
    kw = dict(causal=causal, window=window, chunk=chunk, prefix_len=prefix_len,
              q_offset=q_offset)
    on_card = _on(q, "flash_attention")
    with A.suspended():
        if on_card:
            out, lse = _fwd_cuda(q, k, v, **kw)
        elif q.device.type == "meta":
            _mask_args(causal, window, chunk, prefix_len, q_offset)
            _check(q, k, v)
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
            lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                              device=q.device)
        else:
            # in the kernel's layout (contiguous), so that what the caller
            # does with it is the same on every device
            out, lse = (t.contiguous() for t in flash_attention_fwd_ref(q, k, v, **kw))
    _report("flash_attention", q, k, False, (out, lse), **kw)
    return out, lse


def _fwd_cuda(q, k, v, *, causal, window, chunk, prefix_len, q_offset):
    mask = _mask_args(causal, window, chunk, prefix_len, q_offset)
    _check(q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    maps = tensor_maps(FWD, q, k, v) if uses_tensor_maps(q.dtype, d) else None
    _launch(FWD, [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None, None, None, None, lse.data_ptr(), None],
            [q, k, v, out, None, None, None, None], [b, hq, hkv, sq, sk, d], mask,
            q.dtype == torch.bfloat16, 1.0 / math.sqrt(d), q.device, maps)
    # the count lives on the public entry point, as for the other kernels
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                        causal: bool = True, window: int = 0, chunk: int = 0,
                        prefix_len: int = 0,
                        q_offset: int = 0) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) in the dtypes of (q, k, v) for the output gradient ``g``."""
    kw = dict(causal=causal, window=window, chunk=chunk, prefix_len=prefix_len,
              q_offset=q_offset)
    on_card = _on(q, "flash_attention_bwd")
    with A.suspended():
        if on_card:
            grads = _bwd_cuda(q, k, v, out, lse, g, **kw)
        elif q.device.type == "meta":
            grads = _bwd_meta(q, k, v, out, lse, g, **kw)
        else:
            grads = tuple(t.contiguous() for t in flash_attention_bwd_ref(q, k, v, out, lse,
                                                                           g, **kw))
    _report("flash_attention_bwd", q, k, True, grads, **kw)
    return grads


def _bwd_meta(q, k, v, out, lse, g, *, causal, window, chunk, prefix_len, q_offset):
    """Empty gradients, after the checks the card makes; the scratch the
    kernels allocate (delta, the dK/dV partials) counts towards the peak
    while the call runs."""
    _mask_args(causal, window, chunk, prefix_len, q_offset)
    g = g.contiguous()
    _check(q, k, v, out, g)
    b, sq, hq, d = q.shape
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 ({b}, {hq}, {sq})")
    scratch = [torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)]
    if uses_tensor_maps(q.dtype, d):
        scratch.append(torch.empty(dkv_partial_shape(b, k.shape[1], hq, d),
                                   dtype=torch.float32, device=q.device))
    grads = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    A.track((*scratch, *grads))
    return grads


def _bwd_cuda(q, k, v, out, lse, g, *, causal, window, chunk, prefix_len, q_offset):
    mask = _mask_args(causal, window, chunk, prefix_len, q_offset)
    g = g.contiguous()               # autograd may hand the gradient in strided
    _check(q, k, v, out, g)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({b}, {hq}, {sq})")
    # delta = sum over D of dO * out (a pre-pass kernel), as JAX computes it
    # before its scan
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    tma = uses_tensor_maps(q.dtype, d)
    part = (torch.empty(dkv_partial_shape(b, sk, hq, d), dtype=torch.float32,
                        device=q.device) if tma else None)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            part[0].data_ptr() if tma else None, part[1].data_ptr() if tma else None]
    args = ([q, k, v, out, g, dq, dk, dv], [b, hq, hkv, sq, sk, d], mask,
            q.dtype == torch.bfloat16, 1.0 / math.sqrt(d), q.device)
    _launch(DELTA, ptrs, *args)
    _launch(DKDV, ptrs, *args, tensor_maps(DKDV, q, k, v, g) if tma else None)
    _launch(DQ, ptrs, *args, tensor_maps(DQ, q, k, v, g) if tma else None)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, prefix_len, q_offset):
        opts = dict(causal=causal, window=window, chunk=chunk,
                    prefix_len=prefix_len, q_offset=q_offset)
        out, lse = flash_attention_fwd(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    prefix_len: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Differentiable attention: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) ->
    (B, Sq, Hq, D).  ``window`` > 0 is a sliding window, ``chunk`` > 0
    chunk-local attention, ``prefix_len`` > 0 prefix-LM; query i sits at
    position ``q_offset + i``."""
    return _FlashAttention.apply(q, k, v, causal, window, chunk, prefix_len, q_offset)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
