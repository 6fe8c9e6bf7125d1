"""Counter-based PRNG: JAX's threefry-2x32 stream in NumPy and in torch.

A copy of ``repro.core.prng`` (the NumPy mirror of ``jax.random``'s
threefry stream) plus :func:`counter_fault_masks_torch`, the draw that
takes the place of ``jax.random`` on the device.  Both give bit-identical
masks from the same seed:

  * :func:`threefry_seed`     == ``jax.random.PRNGKey(seed)`` raw key data;
  * :func:`threefry_fold_in`  == ``jax.random.fold_in`` (threefry impl);
  * :func:`threefry_bits`     == ``jax.random.bits(key, (n,), uint32)``;
  * :func:`counter_fault_masks` == :func:`counter_fault_masks_torch`, the
    device-side mask generator of ``repro_torch.sim.torch_backend``.

The mask itself is an integer-threshold comparison (``bits < round(ratio *
2**32)``) rather than a float comparison, so backend equality never hinges
on float rounding.  Both the "original" and "partitionable" threefry bit
layouts are implemented (:func:`threefry_bits`), but the canonical mask
stream of :func:`counter_fault_masks` is pinned to the original layout
everywhere, and the torch draw produces only that layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs

_U32 = np.uint32
_MASK32 = _U32(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# key-schedule injections after each 4-round group: (ks index for x0,
# ks index for x1, round-group counter added to x1)
_INJECT = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))


def _rotl32(x: np.ndarray, d: int) -> np.ndarray:
    d = _U32(d)
    return ((x << d) | (x >> _U32(32 - int(d)))) & _MASK32


def _threefry2x32_inplace(k0: np.ndarray, k1: np.ndarray,
                          x0: np.ndarray, x1: np.ndarray,
                          tmp: np.ndarray) -> None:
    """Threefry-2x32 with broadcast uint32 keys, updating ``x0``/``x1``
    in place (``tmp`` is a scratch buffer of the lane shape).

    Same 20-round schedule as :func:`threefry2x32`; uint32 wraparound is
    exact by construction so no ``errstate`` guard is needed.  The in-place
    formulation exists for :func:`counter_fault_masks`' batched row blocks,
    where per-op temporaries would otherwise dominate the runtime.
    """
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    np.add(x0, ks[0], out=x0)
    np.add(x1, ks[1], out=x1)
    for gi, (a, b, ctr) in enumerate(_INJECT):
        for r in _ROTATIONS[gi % 2]:
            np.add(x0, x1, out=x0)
            # tmp = rotl(x1, r); x1 = x0 ^ tmp
            np.left_shift(x1, _U32(r), out=tmp)
            np.right_shift(x1, _U32(32 - r), out=x1)
            np.bitwise_or(tmp, x1, out=tmp)
            np.bitwise_xor(x0, tmp, out=x1)
        np.add(x0, ks[a], out=x0)
        np.add(x1, ks[b], out=x1)
        np.add(x1, _U32(ctr), out=x1)


def threefry2x32(k0: int, k1: int, c0: np.ndarray,
                 c1: np.ndarray) -> tuple:
    """The raw Threefry-2x32 block cipher on uint32 lanes (20 rounds)."""
    with np.errstate(over="ignore"):
        k0, k1 = _U32(k0), _U32(k1)
        ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
        x0 = (np.asarray(c0, _U32) + ks[0]) & _MASK32
        x1 = (np.asarray(c1, _U32) + ks[1]) & _MASK32
        for gi, (a, b, ctr) in enumerate(_INJECT):
            for r in _ROTATIONS[gi % 2]:
                x0 = (x0 + x1) & _MASK32
                x1 = x0 ^ _rotl32(x1, r)
            x0 = (x0 + ks[a]) & _MASK32
            x1 = (x1 + ks[b] + _U32(ctr)) & _MASK32
    return x0, x1


def threefry_hash(key: np.ndarray, count: np.ndarray) -> np.ndarray:
    """``jax._src.prng.threefry_2x32``: hash a flat uint32 counter stream."""
    count = np.asarray(count, _U32).ravel()
    odd = count.size % 2
    if odd:
        count = np.concatenate([count, np.zeros(1, _U32)])
    half = count.size // 2
    x0, x1 = threefry2x32(key[0], key[1], count[:half], count[half:])
    out = np.concatenate([x0, x1])
    return out[:-1] if odd else out


def threefry_seed(seed: int) -> np.ndarray:
    """Raw key data of ``jax.random.PRNGKey(seed)`` (threefry impl)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=_U32)


def threefry_fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a threefry key."""
    return threefry_hash(key, threefry_seed(data))


def threefry_bits(key: np.ndarray, size: int,
                  partitionable: bool = False) -> np.ndarray:
    """``jax.random.bits(key, (size,), uint32)`` for a threefry key.

    ``partitionable`` selects JAX's ``jax_threefry_partitionable`` stream
    (two parallel 32-bit counter lanes XORed) instead of the original flat
    counter layout.
    """
    if size == 0:
        return np.zeros(0, _U32)
    if partitionable:
        c0 = np.zeros(size, _U32)            # hi 32 bits of a 64-bit iota
        c1 = np.arange(size, dtype=_U32)     # lo 32 bits
        x0, x1 = threefry2x32(key[0], key[1], c0, c1)
        return x0 ^ x1
    return threefry_hash(key, np.arange(size, dtype=_U32))


def threefry_fold_in_batch(key: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Vectorized :func:`threefry_fold_in`: one ``(len(data), 2)`` uint32 key
    matrix, row ``i`` bit-identical to ``threefry_fold_in(key, data[i])``.

    ``fold_in`` hashes the 2-word seed block of each datum, so every row is
    one independent threefry block -- a single broadcast cipher call over
    the whole index vector instead of a Python-level loop.
    """
    data = np.asarray(data, dtype=np.int64)
    hi = ((data >> 32) & 0xFFFFFFFF).astype(_U32)
    lo = (data & 0xFFFFFFFF).astype(_U32)
    x0, x1 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([x0, x1], axis=-1)


def ratio_threshold(ratio: float) -> int:
    """Integer threshold for ``bits < threshold`` Bernoulli(ratio) draws."""
    return min(1 << 32, max(0, int(round(float(ratio) * (1 << 32)))))


#: Row-block budget of the batched mask generator: lanes are processed in
#: blocks of at most ``2**22`` counters so the uint32 working set stays at
#: a few tens of MB regardless of the requested snapshot count.
_MASK_BLOCK_LANES = 1 << 22


def counter_fault_masks(num_nodes: int, node_fault_ratio: float,
                        samples: int, seed: int = 0,
                        partitionable: bool = False,
                        start: int = 0) -> np.ndarray:
    """I.i.d. fault masks from the threefry counter stream.

    Row ``i`` depends only on ``(seed, start + i)`` -- key
    ``fold_in(seed_key, start + i)`` hashed over a per-node counter -- so
    the matrix is invariant under chunking, and both the torch backend
    (on the device, via :func:`counter_fault_masks_torch`) and the
    streaming engine (host, per chunk via ``start``) regenerate identical
    rows without ever materializing the full matrix.

    The whole batch is generated as vectorized broadcast cipher calls over
    bounded row blocks (keys from :func:`threefry_fold_in_batch`, lanes via
    the in-place threefry), bit-identical to the per-row
    ``threefry_bits(threefry_fold_in(root, i), ...)`` reference that
    ``tests/test_torch_prng.py`` pins against ``jax.random``.

    The canonical stream is pinned to the *original* threefry bit layout
    (``partitionable=False``) regardless of the environment, so a seeded
    spec reproduces identically everywhere -- including numpy-only
    installs and JAX releases that flip the ``jax_threefry_partitionable``
    default.
    """
    thresh = ratio_threshold(node_fault_ratio)
    if samples == 0 or num_nodes == 0:
        return np.zeros((samples, num_nodes), dtype=bool)
    if thresh >= (1 << 32):
        return np.ones((samples, num_nodes), dtype=bool)
    with obs.span("prng.counter_fault_masks", samples=samples,
                  nodes=num_nodes, start=start) as sp:
        root = threefry_seed(seed)
        out = np.empty((samples, num_nodes), dtype=bool)
        t32 = _U32(thresh)
        rows_per_block = max(1, _MASK_BLOCK_LANES // max(num_nodes, 1))
        # per-row counter layout: the original stream splits the padded flat
        # iota [0..n-1, (0)] in half; the partitionable stream runs two
        # parallel lanes (hi=0, lo=iota) XORed
        if partitionable:
            half = num_nodes
            c0_row = np.zeros(num_nodes, _U32)
            c1_row = np.arange(num_nodes, dtype=_U32)
        else:
            half = (num_nodes + 1) // 2
            flat = np.arange(2 * half, dtype=_U32)
            flat[num_nodes:] = 0               # odd width pads one zero
            c0_row, c1_row = flat[:half], flat[half:]
        for lo_r in range(0, samples, rows_per_block):
            hi_r = min(lo_r + rows_per_block, samples)
            rows = hi_r - lo_r
            keys = threefry_fold_in_batch(
                root, np.arange(start + lo_r, start + hi_r, dtype=np.int64))
            x0 = np.broadcast_to(c0_row, (rows, half)).copy()
            x1 = np.broadcast_to(c1_row, (rows, half)).copy()
            tmp = np.empty_like(x0)
            _threefry2x32_inplace(keys[:, :1], keys[:, 1:], x0, x1, tmp)
            if partitionable:
                np.bitwise_xor(x0, x1, out=x0)
                np.less(x0, t32, out=out[lo_r:hi_r])
            else:
                np.less(x0, t32, out=out[lo_r:hi_r, :half])
                np.less(x1[:, :num_nodes - half], t32,
                        out=out[lo_r:hi_r, half:])
        obs.count("prng.masks_generated", samples)
        if obs.enabled():
            rss = obs.rss_mb()
            obs.gauge("prng.rss_mb", rss)
            sp.set(rss_mb=round(rss, 1))
    return out


# ------------------------------------------------------------ torch draw
# torch has no CPU add or shifts for torch.uint32, so the draw runs the
# cipher on int64 lanes that hold uint32 values and masks every sum and
# left shift back to 32 bits; the same code runs on the card.

_M32 = 0xFFFFFFFF

#: Lane budget of one step of the torch draw: x0, x1 and one scratch
#: tensor of this many int64 lanes take 3.2 GB, whatever the block size.
_TORCH_BLOCK_LANES = 1 << 27


def _threefry2x32_torch_(k0, k1, x0: torch.Tensor, x1: torch.Tensor,
                         tmp: torch.Tensor) -> None:
    """:func:`_threefry2x32_inplace` on int64 lanes: keys are Python ints
    or int64 tensors that broadcast against the lanes."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for gi, (a, b, ctr) in enumerate(_INJECT):
        for r in _ROTATIONS[gi % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            # tmp = rotl(x1, r); x1 = x0 ^ tmp
            torch.bitwise_left_shift(x1, r, out=tmp)
            tmp.bitwise_and_(_M32)
            x1.bitwise_right_shift_(32 - r)
            tmp.bitwise_or_(x1)
            torch.bitwise_xor(x0, tmp, out=x1)
        x0.add_(ks[a]).bitwise_and_(_M32)
        x1.add_(ks[b]).add_(ctr).bitwise_and_(_M32)


def threefry2x32_torch(k0: int, k1: int, c0: torch.Tensor,
                       c1: torch.Tensor) -> tuple:
    """:func:`threefry2x32` on torch tensors: uint32 values in and out,
    held in int64."""
    x0, x1 = (t.to(torch.int64).clone()
              for t in torch.broadcast_tensors(c0, c1))
    _threefry2x32_torch_(int(k0), int(k1), x0, x1, torch.empty_like(x0))
    return x0, x1


def threefry_fold_in_torch(seed: int, data: torch.Tensor) -> tuple:
    """Row keys ``fold_in(threefry_seed(seed), data[i])`` as two int64
    tensors: :func:`threefry_fold_in_batch` on the tensor's device."""
    root = threefry_seed(seed)
    data = data.to(torch.int64)
    return threefry2x32_torch(root[0], root[1], (data >> 32) & _M32,
                              data & _M32)


def counter_masks_at(idx: torch.Tensor, num_nodes: int,
                     node_fault_ratio: float, seed: int = 0) -> torch.Tensor:
    """Fault masks of the counter-stream snapshots ``idx`` (an integer
    tensor), drawn on ``idx``'s device: row ``i`` is bit-identical to row
    ``idx[i]`` of :func:`counter_fault_masks` (original layout)."""
    rows, device = idx.numel(), idx.device
    thresh = ratio_threshold(node_fault_ratio)
    if rows == 0 or num_nodes == 0:
        return torch.zeros((rows, num_nodes), dtype=torch.bool, device=device)
    if thresh >= (1 << 32):
        return torch.ones((rows, num_nodes), dtype=torch.bool, device=device)
    with obs.span("prng.counter_masks_torch", samples=rows, nodes=num_nodes,
                  device=str(device)):
        # the original stream splits the padded flat iota [0..n-1, (0)] in
        # half: x0 takes the first half, x1 the rest
        half = (num_nodes + 1) // 2
        flat = torch.arange(2 * half, dtype=torch.int64, device=device)
        flat[num_nodes:] = 0                       # odd width pads one zero
        c0, c1 = flat[:half], flat[half:]
        out = torch.empty((rows, num_nodes), dtype=torch.bool, device=device)
        step = max(1, _TORCH_BLOCK_LANES // half)
        for lo in range(0, rows, step):
            hi = min(lo + step, rows)
            k0, k1 = threefry_fold_in_torch(seed, idx[lo:hi])
            x0 = c0.expand(hi - lo, half).clone()
            x1 = c1.expand(hi - lo, half).clone()
            _threefry2x32_torch_(k0[:, None], k1[:, None], x0, x1,
                                 torch.empty_like(x0))
            out[lo:hi, :half] = x0 < thresh
            out[lo:hi, half:] = x1[:, :num_nodes - half] < thresh
            del x0, x1
        obs.count("prng.masks_generated", rows)
    return out


def counter_fault_masks_torch(num_nodes: int, node_fault_ratio: float,
                              rows: int, seed: int = 0, start: int = 0, *,
                              device="cuda") -> torch.Tensor:
    """:func:`counter_fault_masks` drawn on ``device``: a ``(rows,
    num_nodes)`` bool tensor, rows ``start .. start + rows - 1`` of the
    canonical stream.  Takes the place of ``jax.random`` in the JAX
    package's device draw; works in bounded row steps, so the int64
    working set stays at a few GB for any ``rows``."""
    idx = torch.arange(start, start + rows, dtype=torch.int64, device=device)
    return counter_masks_at(idx, num_nodes, node_fault_ratio, seed)


__all__ = [
    "threefry2x32", "threefry_hash", "threefry_seed", "threefry_fold_in",
    "threefry_fold_in_batch", "threefry_bits", "ratio_threshold",
    "counter_fault_masks", "threefry2x32_torch", "threefry_fold_in_torch",
    "counter_masks_at", "counter_fault_masks_torch",
]
