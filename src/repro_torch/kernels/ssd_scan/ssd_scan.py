"""Wrappers of the CUDA SSD-scan kernels (``csrc/ssd_scan.cu``).

``ssd_scan(x, dt, A, B, C, ...)`` is differentiable: a
``torch.autograd.Function`` whose forward runs :func:`ssd_scan_fwd` and
saves the inputs with the chunk-start states and chunk decays the kernels
computed, and whose backward runs :func:`ssd_scan_bwd` and returns the
gradients of all five inputs (``A = -exp(A_log)`` is trained).  Together
they compute what ``repro.kernels.ssd_scan.ssd_scan_pallas`` computes and
its gradient, which JAX takes with XLA.  On CPU tensors each runs its plain
version (:mod:`.ref`); on CUDA tensors it launches the kernels, or raises
when they do not take the inputs; on ``meta`` tensors (the dry run) it
checks the sizes the kernels take and returns empty outputs of their shapes
and dtypes, launching nothing.  On every device each call reports the
kernels' work to a running op-level analysis through
:mod:`repro_torch.obs.op_counts` (:func:`work`, the
chunked algorithm's products).  Tensors keep the JAX layout
(Bt, S, H, P); the kernels read their strides, so no transposed copy is
made.  ``ssd_scan.launches`` counts forward calls and
``ssd_scan_bwd.launches`` backward calls (each launches several kernels).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ...obs import op_counts as A_
from .. import _build
from .ref import _chunk, ssd_scan_bwd_ref, ssd_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)
FWD, BWD = 0, 1              # kernel kinds of the C entry point
# the sizes the kernels take (ssd_scan_limits in csrc/ssd_scan.cu), for the
# meta branch's checks, which cannot ask the library
LIMITS = (128, 128, 64)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_limits.argtypes = [ctypes.c_int]
        lib.ssd_scan_limits.restype = ctypes.c_int
    return lib


@functools.cache
def limits() -> Tuple[int, int, int]:
    """Largest chunk, state size N and head dim P the kernels take."""
    lib = _lib()
    return tuple(lib.ssd_scan_limits(i) for i in range(3))


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def head_groups(chunks: int, heads: int, sms: int) -> int:
    """Head groups of the bf16 forward's output kernel and of the bf16
    backward: a block per (batch, chunk, group) walks its group's heads, so
    with ``chunks`` = Bt * nc blocks per group the groups are as many as
    keep the blocks within one wave of ``sms`` (at least 1, at most one head
    a group) and none is empty.  Each group forms C B^T once; in the
    backward more than one group costs a pass over (groups, Bt, S, N) fp32
    dB/dC partials."""
    g = max(1, min(heads, sms // max(1, chunks)))
    per = -(-heads // g)
    return -(-heads // per)


def _on(t: torch.Tensor, name: str) -> bool:
    """True for CUDA tensors (the kernels), False for CPU ones (the plain
    version) and meta ones (shapes only)."""
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} runs on cpu, cuda or meta, not {t.device}")
    return t.device.type == "cuda"


def work(x: torch.Tensor, dt: torch.Tensor, A_: torch.Tensor, B: torch.Tensor,
         C: torch.Tensor, chunk: int, y_elt: int, backward: bool) -> Tuple[int, int, int]:
    """(FLOPs, bytes, exponentials) of one forward or backward call, by
    the chunked algorithm's products: per (batch, chunk, head) the causal
    half of C B^T and of the intra-chunk product, the inter-chunk output and
    the chunk state, two FLOPs a multiply-add; the backward twice that.
    The forward reads x, dt, A, B, C once and writes y (``y_elt`` bytes an
    element); the backward reads them and dy and writes a gradient of each.
    Exponentials: the causal half of the decay matrix, the decays to the
    chunk's end and from its start and the chunk's decay, recomputed by the
    backward."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    q = _chunk(s, chunk)
    nc = s // q
    tri = q * (q + 1) // 2
    flops = 2 * bt * nc * h * (tri * n + tri * p + 2 * q * n * p)
    ins = sum(t.numel() * t.element_size() for t in (x, dt, A_, B, C))
    y = bt * s * h * p * y_elt
    exps = bt * nc * h * (tri + 2 * q + 1)
    if backward:
        return 2 * flops, 2 * ins + y, exps
    return flops, ins + y, exps


def _meta_check(x, dt, A, B, C, chunk, out_dtype, *grads):
    """:func:`_check` against the kernels' limits as the source states them
    (no library to ask without the card)."""
    return _check(x, dt, A, B, C, chunk, out_dtype, *grads, lims=LIMITS)


def _check(x, dt, A, B, C, chunk, out_dtype, *grads, lims=None):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"want x (Bt, S, H, P), dt (Bt, S, H), A (H,), B/C (Bt, S, N); got "
                         f"{[tuple(t.shape) for t in (x, dt, A, B, C)]}")
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (bt, s, h) or A.shape != (h,) or B.shape[:2] != (bt, s):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}")
    q = _chunk(s, chunk)
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C are {x.dtype}, {B.dtype}, {C.dtype}: the kernels take "
                        f"float32 or bfloat16, the same for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, not {dt.dtype} and {A.dtype}")
    if out_dtype not in _DTYPES or (x.dtype == torch.float32 and out_dtype != torch.float32):
        raise TypeError(f"output {out_dtype} for x {x.dtype}: the kernels write x's dtype "
                        f"or float32")
    tensors = (x, dt, A, B, C, *grads)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    for t in (x, A, B, C, *grads):
        if t.stride(-1) != 1:
            raise ValueError("the last dimension of x, A, B, C and dy must be contiguous")
    for g in grads:
        if g.shape != x.shape or g.dtype != out_dtype:
            raise ValueError(f"dy {tuple(g.shape)} {g.dtype}: want {tuple(x.shape)} {out_dtype}")
    if x.dtype == torch.bfloat16:    # the tensor-core kernels load 16-byte rows
        if n % 8 or p % 8:
            raise ValueError(f"N {n}, P {p}: bfloat16 inputs need multiples of 8")
        for t in (x, B, C, *grads):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
                raise ValueError("rows of x, B, C and dy must start on 16-byte boundaries")
    if bt * h > 65535 or n * p % 4:
        raise ValueError(f"Bt * H = {bt * h}, N * P = {n * p}: the kernels take Bt * H "
                         f"up to 65535 and N * P a multiple of 4")
    qmax, nmax, pmax = lims or limits()
    if q > qmax or n > nmax or p > pmax:
        raise ValueError(f"chunk {q}, N {n}, P {p}: the kernels take chunk <= {qmax}, "
                         f"N <= {nmax}, P <= {pmax}")
    return bt, s, h, p, n, q


def _launch(kind, ptrs, strides, dims, x, out_dtype):
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ssd_scan_launch(kind, c_ptrs, c_strides, c_dims,
                                 int(x.dtype == torch.bfloat16),
                                 int(out_dtype == torch.bfloat16), stream)
    if err:
        name = "forward" if kind == FWD else "backward"
        raise RuntimeError(f"ssd_scan {name} kernel launch failed: "
                           + ("sizes or types not taken" if err < 0 else f"CUDA error {err}"))


def _strides(x, dt, B, C, y, dx=None):
    st = [*x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2], *y.stride()[:3]]
    return st + (list(dx.stride()[:3]) if dx is not None else [0, 0, 0])


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, *, chunk: int = 128,
                 out_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """y (Bt, S, H, P) in ``out_dtype`` (default x's), plus what the backward
    kernels read: the float32 state before every chunk (Bt, nc, H, N, P) and
    every chunk's summed decay (Bt, nc, H).  Both are None on the CPU."""
    out_dtype = out_dtype or x.dtype
    on_card = _on(x, "ssd_scan")
    with A_.suspended():
        if on_card:
            res = _fwd_cuda(x, dt, A, B, C, chunk, out_dtype)
        elif x.device.type == "meta":
            bt, s, h, p, n, q = _meta_check(x, dt, A, B, C, chunk, out_dtype)
            f32 = dict(dtype=torch.float32, device=x.device)
            res = (torch.empty((bt, s, h, p), dtype=out_dtype, device=x.device),
                   torch.empty((bt, s // q, h, n, p), **f32), torch.empty((bt, s // q, h), **f32))
        else:
            res = ssd_scan_ref(x, dt, A, B, C, chunk, out_dtype), None, None
    flops, nbytes, exps = work(x, dt, A, B, C, chunk, torch.finfo(out_dtype).bits // 8, False)
    A_.report_kernel("ssd_scan", flops=flops, nbytes=nbytes, transcendentals=exps,
                     outputs=[t for t in res if t is not None])
    return res


def _fwd_cuda(x, dt, A, B, C, chunk, out_dtype):
    bt, s, h, p, n, q = _check(x, dt, A, B, C, chunk, out_dtype)
    nc = s // q
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bt, s, h, p), dtype=out_dtype, device=x.device)
    states = torch.empty((bt, nc, h, n, p), **f32)
    T = torch.empty((bt, nc, h), **f32)
    groups = head_groups(bt * nc, h, _sm_count(x.device.index)) \
        if x.dtype == torch.bfloat16 else 1
    ptrs = [t.data_ptr() for t in (x, dt, A, B, C, y, states, T)]
    _launch(FWD, ptrs, _strides(x, dt, B, C, y), [bt, s, h, p, n, q, groups], x, out_dtype)
    # the count lives on the public entry point, as for the other kernels
    ssd_scan.launches += 1
    return y, states, T


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, dy: torch.Tensor, states: Optional[torch.Tensor],
                 T: Optional[torch.Tensor], *, chunk: int = 128) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC) in the dtypes of (x, dt, A, B, C) for the output
    gradient ``dy``; ``states`` and ``T`` are what :func:`ssd_scan_fwd`
    returned for the same inputs."""
    on_card = _on(x, "ssd_scan_bwd")
    with A_.suspended():
        if on_card:
            grads = _bwd_cuda(x, dt, A, B, C, dy, states, T, chunk)
        elif x.device.type == "meta":
            grads = _bwd_meta(x, dt, A, B, C, dy, states, T, chunk)
        else:
            grads = ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk)
    flops, nbytes, exps = work(x, dt, A, B, C, chunk, dy.element_size(), True)
    A_.report_kernel("ssd_scan_bwd", flops=flops, nbytes=nbytes, transcendentals=exps,
                     outputs=grads)
    return grads


def _bwd_meta(x, dt, A, B, C, dy, states, T, chunk):
    """Empty gradients after the checks the card makes; the state-gradient
    scratch the kernels allocate counts towards the peak while it runs."""
    dy = dy.contiguous()
    bt, s, h, p, n, q = _meta_check(x, dt, A, B, C, chunk, dy.dtype, dy)
    nc = s // q
    if states is None or states.shape != (bt, nc, h, n, p) or T is None \
            or T.shape != (bt, nc, h):
        raise ValueError("states and T must be what ssd_scan_fwd returned")
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = [torch.empty_like(states), torch.empty((bt, nc, h), **f32)]
    grads = (torch.empty_like(x, memory_format=torch.contiguous_format),
             torch.empty((bt, s, h), **f32), torch.empty((h,), **f32),
             torch.empty((bt, s, n), dtype=B.dtype, device=x.device),
             torch.empty((bt, s, n), dtype=C.dtype, device=x.device))
    A_.track((*scratch, *grads))
    return grads


def _bwd_cuda(x, dt, A, B, C, dy, states, T, chunk):
    dy = dy.contiguous()             # autograd may hand the gradient in strided
    bt, s, h, p, n, q = _check(x, dt, A, B, C, chunk, dy.dtype, dy)
    nc = s // q
    for name, t, shape in (("states", states, (bt, nc, h, n, p)), ("T", T, (bt, nc, h))):
        if t is None or t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, from ssd_scan_fwd")
    f32 = dict(dtype=torch.float32, device=x.device)
    groups = head_groups(bt * nc, h, _sm_count(x.device.index)) \
        if x.dtype == torch.bfloat16 else h
    G = torch.empty_like(states)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    ddt = torch.empty((bt, s, h), **f32)
    partials = groups > 1 or x.dtype == torch.float32    # else dB, dC written directly
    dBp = torch.empty((groups, bt, s, n), **f32) if partials else None
    dCp = torch.empty((groups, bt, s, n), **f32) if partials else None
    dAp = torch.empty((bt, nc, h), **f32)
    dB = torch.empty((bt, s, n), dtype=B.dtype, device=x.device)
    dC = torch.empty((bt, s, n), dtype=C.dtype, device=x.device)
    dA = torch.empty((h,), **f32)
    ptrs = [t.data_ptr() if t is not None else None
            for t in (x, dt, A, B, C, dy, states, T, G, dx, ddt, dBp, dCp, dAp, dB, dC, dA)]
    _launch(BWD, ptrs, _strides(x, dt, B, C, dy, dx), [bt, s, h, p, n, q, groups], x,
            dy.dtype)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, out_dtype):
        y, states, T = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk, out_dtype=out_dtype)
        ctx.save_for_backward(x, dt, A, B, C, states, T)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, states, T = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, B, C, dy, states, T, chunk=ctx.chunk)
        return (*grads, None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable chunked SSD scan without the D term: x (Bt, S, H, P),
    dt (Bt, S, H) float32 (post-softplus), A (H,) float32 (negative),
    B/C (Bt, S, N) -> y (Bt, S, H, P) in ``out_dtype`` (default x's), over
    chunks of ``min(chunk, S)`` rows."""
    return _SSDScan.apply(x, dt, A, B, C, chunk, out_dtype or x.dtype)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
