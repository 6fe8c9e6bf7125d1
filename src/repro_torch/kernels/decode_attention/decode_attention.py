"""Wrapper of the CUDA flash-decode kernel (``csrc/decode_attention.cu``).

Two entry points, one kernel with two masks:

* ``decode_attention(q, k_cache, v_cache, lengths)`` computes what
  ``repro.kernels.decode_attention.decode_attention_pallas`` computes: keys
  at or past ``lengths[b]`` are ignored;
* ``decode_attention_cache(q, k_cache, v_cache, slot_pos, q_pos, *,
  window=0, chunk=0)`` computes ``decode_attention_cache_xla``: attention
  against a ring-buffer cache whose slots carry absolute positions.

On CPU tensors each runs its plain version (:mod:`.ref`); on CUDA tensors
it launches the kernel once, or raises when the kernel does not take the
inputs; on ``meta`` tensors (the dry run) it checks them as for the card and
returns empty outputs of the kernel's shapes and dtypes, launching nothing.
On every device each call reports the kernel's work to a running op-level
analysis through :mod:`repro_torch.obs.op_counts` (:func:`work`).
``decode_attention.launches`` counts kernel launches of both.

``decode_attention_cache(..., return_lse=True)`` is the log-sum-exp form
that a cache split over several ranks needs: the kernel also writes each
row's log-sum-exp and writes the output in float32, so that the partial
rows merge across ranks (:func:`repro_torch.models.layers.merge_partials`)
before anything rounds to q's type.

The kernel splits each row's key axis (a row: a batch lane, KV head and
group of up to 16 query heads) into whole tiles (:func:`num_splits`).  A
row of at most ``MAX_SPLITS`` splits is one thread-block cluster whose
blocks merge in shared memory, as on every shape where the rows alone give
most SMs a block.  With few rows (a long cache at small batch) a row takes
more splits, enough to fill the card, and they merge through device memory:
each block writes a float32 partial to a workspace this wrapper allocates,
and the last blocks to finish merge them in split order, in groups and then
the groups (:func:`merge_group`), counting arrivals on int32 counters kept
at zero a card (:func:`_tickets`).  Either way a call is one launch and its
results repeat bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ...obs import op_counts as A
from .. import _build
from .ref import decode_attention_cache_ref, decode_attention_ref

#: keys per tile of the tensor-core kernel; a split is a whole number of them
TILE_K = 64
#: query heads of one block: the M of the tensor cores' m16n8k16 product
HEADS_PER_BLOCK = 16
#: fewest keys a split streams, so that each block keeps a ring of tiles
#: busy instead of paying its fixed cost for one tile
MIN_SPLIT_KEYS = 128
#: a row of at most this many splits is one (portable) thread-block
#: cluster, whose blocks merge in shared memory
MAX_SPLITS = 8
#: blocks an SM holds at once where a row takes more splits: the
#: tensor-core kernel's 3-stage ring of 64-key tiles leaves room for two at
#: D <= 128 (one at D = 256)
BLOCKS_PER_SM = 2
#: partials one merge through device memory takes: a row of more splits
#: merges in two steps, groups and then the groups, so it takes at most
#: MAX_MERGE ** 2 splits
MAX_MERGE = 64
#: a row of up to this many splits merges through memory in one step
MERGE_ONE_STEP = 16
_DTYPES = (torch.float32, torch.bfloat16)
LENGTHS, SLOTS = 0, 1        # the kernel's two masks


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def num_splits(units: int, seq: int, sms: int) -> tuple:
    """(n_split, chunk) for ``units`` rows of query heads over ``seq`` keys,
    each split at least MIN_SPLIT_KEYS keys (one split for a shorter cache)
    and a whole number of tiles, none empty; the kernel streams a long split
    in passes.  Where MAX_SPLITS splits a row give at least half the SMs a
    block (``units * MAX_SPLITS >= sms / 2``), about one block per SM in all
    and at most MAX_SPLITS a row: one cluster.  Below that, about
    BLOCKS_PER_SM blocks per SM in all, at most MAX_MERGE ** 2 a row: more
    than MAX_SPLITS merge through device memory.  Depends on shapes only,
    never on the masks' values, so choosing it needs no device sync."""
    if 2 * units * MAX_SPLITS >= sms:
        cap = min(_cdiv(sms, units), MAX_SPLITS)
    else:
        cap = min(_cdiv(BLOCKS_PER_SM * sms, units), MAX_MERGE ** 2)
    n = max(1, min(cap, _cdiv(seq, MIN_SPLIT_KEYS)))
    chunk = _cdiv(_cdiv(seq, n), TILE_K) * TILE_K
    return _cdiv(seq, chunk), chunk


def merge_group(n_split: int) -> int:
    """Splits a group of the merge through device memory takes, or 0 for a
    row of at most MAX_SPLITS splits (one cluster).  Up to MERGE_ONE_STEP
    splits merge in one step (one group); more in two, groups of about the
    square root of the splits, so that each step reads few partials."""
    if n_split <= MAX_SPLITS:
        return 0
    return n_split if n_split <= MERGE_ONE_STEP else math.isqrt(n_split - 1) + 1


class Plan(NamedTuple):
    """How one call splits and merges: ``units`` rows, ``n_split`` splits a
    row of ``split_keys`` keys, merged in one cluster (``group`` 0) or
    through device memory in groups of ``group`` splits."""
    units: int
    n_split: int
    split_keys: int
    group: int

    @property
    def merge(self) -> str:
        return "cluster" if self.group == 0 else "memory"


def plan(b: int, hq: int, hkv: int, seq: int, sms: int) -> Plan:
    """The :class:`Plan` of a call with q (b, hq, D) over a cache of ``seq``
    slots and ``hkv`` KV heads on a card of ``sms`` SMs."""
    units = b * hkv * _cdiv(hq // hkv, HEADS_PER_BLOCK)
    n_split, split_keys = num_splits(units, seq, sms)
    return Plan(units, n_split, split_keys, merge_group(n_split))


def workspace_floats(pl: Plan, hq: int, hkv: int, d: int) -> int:
    """float32s of the merge through memory's workspace: a partial (acc of
    hs = min(rep, 16) head rows, and their m and l padded to 4 floats) for
    every split and group of every row; the kernel keeps all the acc first
    and all the (m, l) after them."""
    hs = min(hq // hkv, HEADS_PER_BLOCK)
    groups = _cdiv(pl.n_split, pl.group)
    return pl.units * (pl.n_split + groups) * _cdiv(hs * (d + 2), 4) * 4


_TICKETS: dict = {}


def _tickets(device: torch.device, count: int) -> torch.Tensor:
    """The merge through memory's int32 counters on ``device``, at least
    ``count`` of them: zeroed when made and kept for the process, so that a
    CUDA graph may hold their address.  Every launch leaves each counter it
    takes at 0 (the block that takes its last ticket resets it), so the
    next launch on the stream, or a graph's replay, finds them at 0.  Made
    outside graph capture (a first call on a card, or one needing more,
    must not be captured) and waited for, so that any stream sees the
    zeros."""
    buf = _TICKETS.get(device.index)
    if buf is None or buf.numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: call it once outside CUDA-graph capture "
                               "at this size first; its merge counters are made then")
        buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)
        _TICKETS[device.index] = buf
    return buf


def _check(q, k_cache, v_cache, ints):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B, Hq, D) and caches (B, S, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, hq, d = q.shape
    bk, s, hkv, dk = k_cache.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv or s == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up to 256")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v "
                        f"{v_cache.dtype}: the kernel takes float32 or bfloat16")
    for name, t, shape in ints:
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be int32 of shape {shape}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    devs = {t.device for t in (q, k_cache, v_cache, *(t for _, t, _ in ints))}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    vec = 16 // k_cache.element_size()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must start on 16-byte boundaries")


def _launch(mode, q, k_cache, v_cache, lengths=None, slot_pos=None, q_pos=None,
            window=0, chunk=0, with_lse=False):
    qvec = 16 // q.element_size()
    if q.data_ptr() % 16 or q.stride(0) % qvec or q.stride(1) % qvec:
        q = q.clone(memory_format=torch.contiguous_format)   # the kernel loads 16-byte rows
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    pl = plan(b, hq, hkv, s, _sm_count(q.device.index))
    ws = tickets = None
    if pl.group:
        ws = torch.empty(workspace_floats(pl, hq, hkv, d), dtype=torch.float32,
                         device=q.device)
        tickets = _tickets(q.device, pl.units * (_cdiv(pl.n_split, pl.group) + 1))
    out, lse = _outputs(q, with_lse)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    ptrs = (ctypes.c_void_p * 10)(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(lengths), ptr(slot_pos), ptr(q_pos), ptr(out),
        ptr(lse), ptr(ws), ptr(tickets))
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3],
        slot_pos.stride(0) if slot_pos is not None else 0)
    dims = (ctypes.c_int * 13)(
        mode, b, hq, hkv, s, d, pl.n_split, pl.split_keys, window, chunk,
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16), pl.group)
    err = _lib().decode_attention_launch(ptrs, strides, dims, 1.0 / math.sqrt(d),
                                         torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           + ("sizes not taken" if err < 0 else f"CUDA error {err}"))
    decode_attention.launches += 1
    return (out, lse) if with_lse else out


def _outputs(q, with_lse):
    """The kernel's outputs for q (B, Hq, D): out in q's type, or in float32
    with the (B, Hq) float32 lse of the log-sum-exp form (else None)."""
    b, hq, d = q.shape
    if not with_lse:
        return torch.empty((b, hq, d), dtype=q.dtype, device=q.device), None
    return (torch.empty((b, hq, d), dtype=torch.float32, device=q.device),
            torch.empty((b, hq), dtype=torch.float32, device=q.device))


def work(q: torch.Tensor, k_cache: torch.Tensor, ints=(), with_lse: bool = False):
    """(FLOPs, bytes, exponentials) of one call, from the shapes alone: 4 D
    FLOPs and one exponential for every (query head, slot) pair, reading q,
    both caches and the integer masks once and writing the output (and lse).
    The kernel skips the tiles with no valid key, so on a cache that is not
    full this is what the call could need at most."""
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    pairs = b * hq * s
    out_bytes = (4 if with_lse else q.element_size()) * b * hq * d
    nbytes = (q.element_size() * b * hq * d + 2 * k_cache.element_size() * b * s * hkv * d
              + out_bytes + sum(t.numel() * t.element_size() for t in ints)
              + (4 * b * hq if with_lse else 0))
    return 4 * pairs * d, nbytes, pairs


def _on(q: torch.Tensor) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version) and meta ones (shapes only)."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention runs on cpu, cuda or meta, not {q.device}")
    return q.device.type == "cuda"


def _report(q, k_cache, ints, outputs, with_lse=False):
    flops, nbytes, exps = work(q, k_cache, ints, with_lse)
    A.report_kernel("decode_attention", flops=flops, nbytes=nbytes, transcendentals=exps,
                    outputs=outputs)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) int32 -> (B, Hq, D)
    in q's dtype.  Keys at or past ``lengths[b]`` are ignored."""
    on_card = _on(q)
    with A.suspended():
        if q.device.type == "cpu":
            out = decode_attention_ref(q, k_cache, v_cache, lengths)
        else:
            _check(q, k_cache, v_cache, [("lengths", lengths, (q.shape[0],))])
            out = (_launch(LENGTHS, q, k_cache, v_cache, lengths=lengths) if on_card
                   else _outputs(q, False)[0])
    _report(q, k_cache, (lengths,), (out,))
    return out


def decode_attention_cache(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, slot_pos: torch.Tensor,
                           q_pos: torch.Tensor, *, window: int = 0,
                           chunk: int = 0, return_lse: bool = False):
    """q: (B, 1, Hq, D); caches: (B, W, Hkv, D); slot_pos: (B, W) int32, the
    absolute position in each slot (-1 = empty); q_pos: (B,) int32 ->
    (B, 1, Hq, D) in q's dtype.  A slot counts when ``0 <= slot_pos <=
    q_pos``, within ``window`` positions of ``q_pos`` (``window`` > 0) and
    in its chunk of ``chunk`` positions (``chunk`` > 0).  A row with no
    such slot gives zeros on the card, where the plain version averages
    every slot; the model's decode always holds the query's own slot.

    With ``return_lse`` the result is ``(out, lse)``: ``out`` (B, 1, Hq, D)
    in float32 and ``lse`` (B, Hq) float32, each row's natural log-sum-exp
    of its scaled logits over its valid slots.  A row with no valid slot
    gets -inf on the card; the plain version's gets -1e30 + log W beside
    the mean of V, as its -1e30 mask gives.  Either weighs 0 in a merge
    with a row that holds a slot."""
    on_card = _on(q)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"want q (B, 1, Hq, D); got {tuple(q.shape)}")
    if window < 0 or chunk < 0:
        raise ValueError(f"window {window} and chunk {chunk} must not be negative")
    with A.suspended():
        if q.device.type == "cpu":
            res = decode_attention_cache_ref(q, k_cache, v_cache, slot_pos, q_pos,
                                             window=window, chunk=chunk, return_lse=return_lse)
        else:
            b, w = k_cache.shape[:2] if k_cache.dim() == 4 else (None, None)
            _check(q[:, 0], k_cache, v_cache,
                   [("slot_pos", slot_pos, (b, w)), ("q_pos", q_pos, (q.shape[0],))])
            if on_card:
                res = _launch(SLOTS, q[:, 0], k_cache, v_cache, slot_pos=slot_pos,
                              q_pos=q_pos, window=window, chunk=chunk, with_lse=return_lse)
            else:
                out, lse = _outputs(q[:, 0], return_lse)
                res = (out, lse) if return_lse else out
            res = (res[0][:, None], res[1]) if return_lse else res[:, None]
    _report(q[:, 0], k_cache, (slot_pos, q_pos), res if return_lse else (res,), return_lse)
    return res


decode_attention.launches = 0
