#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository's ``src/``; without them it
exits non-zero before printing any result.  Phases, each of which raises on
failure:

  1. print the card's name and power limit; build every CUDA kernel of the
     port from ``src/repro_torch/csrc`` (one nvcc per source, together);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it;
  3. serve reduced StarCoder2 with the same float32 weights on the CPU
     (plain versions) and on the card (kernels): the token streams agree;
  4. the main path: full-width, full-depth StarCoder2-3B with random bf16
     weights serves 8 requests through ``ServeEngine``; every request
     finishes and each decode step launched the kernel once per layer;
     a few more engine steps run under torch.profiler to show where a
     step's time goes;
  5. time each kernel, its plain version and the PyTorch library call that
     computes the same function, beside the card's least time for the work.

The last lines are the ``{"kernels": ...}`` record, the card line and
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
KERNELS = ["decode_attention"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build(KERNELS)
    dt = time.perf_counter() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {len(reports)} of {len(KERNELS)} sources compiled in {dt:.2f} s")


# ------------------------------------------------------------ phase 2


def attention_inputs(torch, seed, b, hq, hkv, d, s, qdt, kvdt, max_len=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(qdt)
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(kvdt)
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(kvdt)
    top = max_len or s
    lengths = torch.randint(1, top + 1, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0] = 1
    lengths[1] = top
    return q, k, v, lengths


def check_decode_attention(torch):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)

    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, B, Hq, Hkv, D, S, q dtype, cache dtype, longest length)
        ("serve cache, bf16", 8, 24, 2, 128, 1024, bf, bf, 64),
        ("S=1000 bf16", 8, 24, 2, 128, 1000, bf, bf, None),
        ("S=1000 f32", 8, 24, 2, 128, 1000, f32, f32, None),
        ("S=4096 bf16", 8, 24, 2, 128, 4096, bf, bf, None),
        ("S=4096 f32", 8, 24, 2, 128, 4096, f32, f32, None),
        ("rep=1 S=1000 bf16", 8, 2, 2, 128, 1000, bf, bf, None),
        ("f32 q, bf16 cache", 8, 24, 2, 128, 1024, f32, bf, None),
    ]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for seed, (label, b, hq, hkv, d, s, qdt, kvdt, top) in enumerate(cases):
        q, k, v, lengths = attention_inputs(torch, seed, b, hq, hkv, d, s,
                                            qdt, kvdt, top)
        out = decode_attention(q, k, v, lengths)
        ref = decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        key = "bfloat16" if bf in (qdt, kvdt) else "float32"
        tol = TOL[key]
        err = (out.float() - ref.float()).abs().max().item()
        ok = out.dtype == q.dtype and out.shape == q.shape and torch.allclose(
            out.float(), ref.float(), atol=tol, rtol=tol)
        print(f"decode_attention {label}: max_abs_err {err:.3e} (tol {tol}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention disagrees with its plain "
                                 f"version on {label}: max abs err {err}")
        errs[key] = max(errs[key], err)
    return errs


# ------------------------------------------------------------ phases 3, 4


def serve(engine, request_cls, vocab, n, prompt_len, max_new, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = [request_cls(i, rng.integers(0, vocab, prompt_len).tolist(),
                        max_new=max_new) for i in range(n)]
    pending = list(reqs)
    while pending:
        while pending and engine.submit(pending[0]):
            pending.pop(0)
        engine.step()
    left = engine.run_until_done()
    if left or not all(r.done for r in reqs):
        raise AssertionError(f"{len(left)} requests did not finish")
    return reqs


def check_reduced_against_cpu(torch):
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = get_arch("starcoder2").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.float32)
    streams = {}
    for dev in ("cpu", "cuda"):
        model = model.to(dev)
        eng = ServeEngine(cfg, model, max_batch=2, max_len=32, device=dev)
        streams[dev] = [r.out for r in serve(eng, Request, cfg.vocab_size,
                                             3, 5, 6, seed=2)]
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"reduced model: card {streams['cuda']} != "
                             f"cpu {streams['cpu']}")
    print(f"reference: reduced {cfg.name}, float32 weights, 3 requests: card "
          f"token streams equal the CPU plain path's")


def serve_full(torch):
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = get_arch("starcoder2")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"model: {cfg.name}, {len(model.layers)} layers, d_model {cfg.d_model}, "
          f"{weight_bytes / 1e9:.3f} GB of weights, made in "
          f"{time.perf_counter() - t0:.2f} s")

    batch, max_len, n_req, prompt_len, max_new = 8, 1024, 8, 32, 32
    warm = ServeEngine(cfg, model, max_batch=batch, max_len=max_len)
    serve(warm, Request, cfg.vocab_size, 1, 4, 3, seed=99)
    del warm

    eng = ServeEngine(cfg, model, max_batch=batch, max_len=max_len)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                    max_new=max_new) for i in range(n_req)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.enable()
    obs.reset()
    decode_attention.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.rid} found no free slot")
    prefill_steps = obs.summary()["counters"]["serve.decode_steps"]
    t1 = time.perf_counter()
    left = eng.run_until_done()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = decode_attention.launches
    counters = obs.summary()["counters"]
    obs.disable()

    steps = counters["serve.decode_steps"]
    decode_steps = steps - prefill_steps
    if left or not all(r.done and len(r.out) == max_new for r in reqs):
        raise AssertionError("not every request finished with max_new tokens")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    if counters.get("serve.requests_completed") != n_req:
        raise AssertionError(f"completed {counters.get('serve.requests_completed')}")
    if launches != cfg.num_layers * steps:
        raise AssertionError(f"decode_attention launched {launches} times in "
                             f"{steps} decode steps of {cfg.num_layers} layers")
    tokens = sum(len(r.out) for r in reqs)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"serve: {n_req} requests, {tokens} tokens, {steps} decode steps "
          f"({prefill_steps} prefill + {decode_steps} engine steps), "
          f"{tokens / (t2 - t0):.1f} tok/s overall, "
          f"{(t2 - t0) / steps * 1e3:.3f} ms per decode step overall, "
          f"{(t1 - t0) / prefill_steps * 1e3:.3f} ms per prefill step, "
          f"{(t2 - t1) / decode_steps * 1e3:.3f} ms per engine step "
          f"({n_req * decode_steps / (t2 - t1):.1f} tok/s), weight-streaming "
          f"bound {bound_ms:.3f} ms per step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"serve: decode_attention launches {launches} = {cfg.num_layers} x "
          f"{steps} steps")
    profile_engine_steps(torch, eng)
    return launches


# ------------------------------------------------------------ phase 5


def eager_ms(torch, fn, n_buf, iters=50, repeats=7):
    """Time per call of back-to-back eager calls, CUDA events around them.
    When the host cannot launch as fast as the card runs, this is the
    host's launch cost per call."""
    for i in range(3):
        fn(i % n_buf)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i % n_buf)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(torch, fn, n_buf, iters=20, repeats=7):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between CUDA events, so the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_buf)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_buf)
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def time_decode_attention(torch, label, s, max_len=None):
    """Kernel, plain version and SDPA at B=8 StarCoder2 heads, bf16, over a
    cache of S slots: all live, or random lengths up to ``max_len``.  Calls
    cycle over enough caches to exceed the 50 MB L2, as 30 layers do."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)

    b, hq, hkv, d = 8, 24, 2, 128
    bf = torch.bfloat16
    kv_bytes = 2 * b * s * hkv * d * 2
    n_buf = max(2, math.ceil(120e6 / kv_bytes))
    bufs = [attention_inputs(torch, 100 + i, b, hq, hkv, d, s, bf, bf, max_len)
            for i in range(n_buf)]
    lengths = bufs[0][3]
    if max_len is None:                              # every slot live
        lengths.fill_(s)
    bufs = [(q, k, v, lengths) for q, k, v, _ in bufs]
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    sdpa_in = [(q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2))
               for q, k, v, _ in bufs]

    def kernel(i):
        return decode_attention(*bufs[i])

    def plain(i):
        return decode_attention_ref(*bufs[i])

    def library(i):
        return F.scaled_dot_product_attention(*sdpa_in[i], attn_mask=mask,
                                              enable_gqa=True)

    kernel_ms = graph_ms(torch, kernel, n_buf)
    kernel_eager_ms = eager_ms(torch, kernel, n_buf)
    plain_ms = graph_ms(torch, plain, n_buf, iters=5)
    library_ms = graph_ms(torch, library, n_buf)
    library_eager_ms = eager_ms(torch, library, n_buf)
    live = int(lengths.sum().item())
    nbytes = (2 * live * hkv * d * 2          # the K and V rows the step needs
              + 2 * b * hq * d * 2 + b * 4)   # q, out, lengths
    ops = 4 * live * hq * d
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOPS else "operations"
    print(f"time decode_attention {label}: B={b} Hq={hq} Hkv={hkv} D={d} S={s} "
          f"live keys {live}, bf16: kernel {kernel_ms * 1e3:.2f} us on the card "
          f"({nbytes / kernel_ms / 1e6:.0f} GB/s), {kernel_eager_ms * 1e3:.2f} us "
          f"eager; bound {bound_ms * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB); "
          f"plain {plain_ms * 1e3:.2f} us; sdpa {library_ms * 1e3:.2f} us on the "
          f"card, {library_eager_ms * 1e3:.2f} us eager")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms,
            "eager_ms": kernel_eager_ms, "library_eager_ms": library_eager_ms}


def profile_engine_steps(torch, eng, n_steps=4):
    """Where an engine step's time goes: the device kernels of a few
    lockstep steps of a full batch, under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    for i in range(eng.max_batch):
        if not eng.submit(Request(1000 + i, rng.integers(0, eng.cfg.vocab_size, 4).tolist(),
                                  max_new=n_steps + 4)):
            raise AssertionError("profile: no free slot")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_done()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device kernels")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for st, en in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(t for n, t in by_name.items() if "decode_attention" in n)
    print(f"profile: {n_steps} engine steps of batch {eng.max_batch}: "
          f"{wall_ms / n_steps:.3f} ms per step under the profiler, device busy "
          f"{busy / 1e3 / n_steps:.3f} ms per step ({100 * (1 - busy / 1e3 / wall_ms):.1f}% "
          f"idle), {len(kernels) / n_steps:.0f} kernels per step, flash-decode "
          f"{attn / 1e3 / n_steps:.3f} ms per step")
    for name, t in top:
        print(f"profile: {t / 1e3 / n_steps:8.3f} ms per step  {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    build_kernels()

    errs = check_decode_attention(torch)
    check_reduced_against_cpu(torch)
    launches = serve_full(torch)
    times = {label: time_decode_attention(torch, label, s, top)
             for label, s, top in [("serve", 1024, 64), ("L=1024", 1024, None),
                                   ("L=4096", 4096, None)]}
    print(json.dumps({"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:65",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_err_bf16": errs["bfloat16"],
        "max_err_f32": errs["float32"],
        "shape": "B=8 Hq=24 Hkv=2 D=128 S=L=1024 bf16",
        **times["L=1024"],
        "serve_shape": times["serve"],
        "L4096": times["L=4096"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
