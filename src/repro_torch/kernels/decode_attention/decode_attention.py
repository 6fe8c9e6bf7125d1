"""Wrapper of the CUDA flash-decode kernel (``csrc/decode_attention.cu``).

``decode_attention(q, k_cache, v_cache, lengths)`` computes what
``repro.kernels.decode_attention.decode_attention_pallas`` computes.  On
CPU tensors it runs the plain version :func:`decode_attention_ref`; on
CUDA tensors it launches the kernel, or raises when the kernel does not
take the inputs.  ``decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from .ref import decode_attention_ref

#: keys per tile in the kernel; a split of the key axis is a whole number of tiles
TILE_K = 32
#: blocks per SM the key split aims for: 4 blocks of the kernel fit on an SM
#: at StarCoder2's shapes, and 4 timed fastest of 2, 4 and 8 on an H100
BLOCKS_PER_SM = 4
SMEM_LIMIT = 232448          # bytes of shared memory a block may use on Hopper
_DTYPES = (torch.float32, torch.bfloat16)

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_p] * 6 + [_i] * 7 + [_ll] * 8 + [_i, _i, ctypes.c_float, _p]
        fn.restype = _i
        lib.decode_attention_smem_bytes.argtypes = [_i, _i, _i]
        lib.decode_attention_smem_bytes.restype = _i
    return lib


@functools.cache
def _smem_bytes(rep: int, d: int, kv_bytes: int) -> int:
    return _lib().decode_attention_smem_bytes(rep, d, kv_bytes)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(batch: int, kv_heads: int, seq: int, sms: int) -> tuple:
    """(n_split, chunk): split the key axis so that about BLOCKS_PER_SM
    blocks per SM run, each split a whole number of tiles.  Depends on
    shapes only, never on ``lengths``, so choosing it needs no device sync."""
    n = max(1, min(_cdiv(BLOCKS_PER_SM * sms, batch * kv_heads), _cdiv(seq, TILE_K)))
    chunk = _cdiv(_cdiv(seq, n), TILE_K) * TILE_K
    return _cdiv(seq, chunk), chunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(q, k_cache, v_cache, lengths):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B, Hq, D) and caches (B, S, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, hq, d = q.shape
    bk, s, hkv, dk = k_cache.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up to 256")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v "
                        f"{v_cache.dtype}: the kernel takes float32 or bfloat16")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise TypeError(f"lengths must be int32 of shape ({b},)")
    devs = {t.device for t in (q, k_cache, v_cache, lengths)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    vec = 16 // k_cache.element_size()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must start on 16-byte boundaries")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) int32 -> (B, Hq, D)
    in q's dtype.  Keys at or past ``lengths[b]`` are ignored."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_cache, v_cache, lengths)
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    smem = _smem_bytes(hq // hkv, d, k_cache.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"rep {hq // hkv} x head dim {d} needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    n_split, chunk = num_splits(b, hkv, s, _sm_count(q.device.index))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    part = (torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        b, hq, hkv, s, d, n_split, chunk,
        q.stride(0), q.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3],
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
        1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
