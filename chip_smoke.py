#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository's ``src/``; without them it
exits non-zero before printing any result.  Phases, each of which raises on
failure:

  1. print the card's name and power limit; build every CUDA kernel of the
     port from ``src/repro_torch/csrc`` (one nvcc per source, together,
     flash-decode's in four parts); meanwhile a process of its own, which
     needs no card, computes the numpy references of phases 28, 30 and
     33-36 (``Background``), and once the build is done another replays phase
     37's trace;
  2. hold each kernel against its plain PyTorch version on the card: the
     flash-decode kernel with both masks, lengths at the shapes the
     serving path gives it and ring-buffer slot positions on wrapped,
     windowed, chunked and half-empty caches, D = 40 to 256, rep 1 to 20,
     f32, bf16, f32 q with a bf16 cache and strided caches, caches of
     140,000 slots (key splits streamed in passes), plus a bit-identical
     repeat of calls whose key splits it merges; the
     flash-attention forward and both backward kernels in float32 and
     bfloat16 under every mask, at ragged lengths (S=1000, S=4095), at
     D=64 with 12 query heads a KV head, at D=80 (H2O-Danube's heads) and
     D=96 (GPT-MoE's), on q/k/v cut from one packed QKV tensor and at
     StarCoder2's training shape, whose backward must also be
     bit-identical when run twice; in bfloat16 also at H2O-Danube's and
     Mixtral's training shapes (S=8192, Hq=32, Hkv=8, D=80 and D=128)
     under their 4096-position sliding window;
  3. serve reduced StarCoder2 with the same float32 weights on the CPU
     (plain versions) and on the card (kernels), also with prompts longer
     than max_len, which wrap the ring cache: the token streams agree;
  4. serving main path: full-width, full-depth StarCoder2-3B with random
     bf16 weights serves 8 requests through ``ServeEngine``; every request
     finishes and each decode step launched the kernel once per layer;
     a few more engine steps run under torch.profiler;
  5. train reduced StarCoder2 in float32 for 3 steps on the CPU (plain
     versions) and on the card (kernels): losses and weights agree;
  6. training main path: full-width, full-depth StarCoder2-3B, bf16, B=1,
     S=4096, remat, AdamW, through ``make_train_step``: one warm-up step,
     then 3 timed steps with finite loss and grad norm, changed weights and
     exactly 2 x layers forward and 1 x layers backward flash-attention
     launches per step; one more step runs under torch.profiler;
  7. time each kernel, its plain version and the PyTorch library call that
     computes the same function, beside the card's least time for the work
     (the flash backward's delta, dK/dV, reduction and dQ passes also
     apart, under torch.profiler; flash-decode also in its slot form on a
     wrapped cache);
  8. reduced H2O-Danube (sliding window), Mixtral (sliding window, MoE)
     and Llama-4 Maverick (chunked attention, MoE with a shared expert)
     in float32 on the CPU and on the card: ServeEngine token streams of
     prompts past the window of 32 are equal, and 3 AdamW steps at S=64
     agree in losses and weights;
  9. H2O-Danube-1.8B training main path: full width and depth (24
     layers), bf16, B=1, S=8192 past the 4096 window, as phase 6: 48
     forward and 24 backward flash-attention launches per step;
 10. H2O-Danube-1.8B serving: 8 requests as phase 4, 24 flash-decode
     launches per decode step;
 11. Mixtral-8x7B at full width and 2 of its 32 layers (what AdamW's
     state leaves room for on 80 GB): training as phase 9, MFU on active
     parameters, the dropped expert assignments of a batch and the MoE
     routing, scatter, experts and combine shares of a profiled step;
     serving as phase 10 with the dropped assignments;
 12. Llama-4 Maverick at full width and 2 layers (a chunked layer with a
     dense MLP, one with 128 experts, top-1, and a shared expert; 18.55 B
     parameters): serving as phase 10 with the dropped assignments;
 13. the flash kernels at PaliGemma-3B's training shape (B=1, S=4096,
     prefix 256, MQA 8 over 1 KV head, D=256, bf16: the DMAX-256 wgmma
     kernels) and Whisper-small's encoder (B=16, 1500 x 1500) and
     cross-attention (448 x 1500), D=64, non-causal, in float32 and bf16:
     absolutely and per band against the reference's scale, and plain
     versions planted with a prefix of 256 ± 64 and with 1500 - 64 keys
     fail that check; the bf16 kernels at D > 128 on edge cases (S=4095
     with 2 KV heads, Sq != Sk with a query offset, a chunk mask, packed
     QKV views, Sk > Sq non-causal, D=192), absolutely and per band, each
     launching only the wgmma kernels, float32 at D=256 only the 3xTF32
     ones, and the forward and backward at PaliGemma's shape bit-identical
     when run twice; the float32 (3xTF32 tensor-core) kernels: only they
     run at both Whisper shapes, bit-identical twice at the encoder's, and
     on edge cases (window, chunk 200, prefix 256, a query offset, D=80,
     GQA 8/2, packed QKV views, a broadcast KV head) absolutely and per
     band; flash-decode at
     PaliGemma's serving shape (slot form, D=256, MQA) and Whisper's
     cross-attention (lengths form, L=1500, bf16 q over a float32 cache),
     with a plain version planted with 1500 - 64 keys caught;
 14. reduced PaliGemma (prefix 4) and Whisper (2 encoder layers over 16
     frames) in float32 on the CPU and on the card: ServeEngine token
     streams are equal (Whisper's caches filled by ``encode_to_cache``)
     and 3 AdamW steps agree;
 15. PaliGemma-3B, all 18 layers: trained at B=1, S=4096 (256 patches +
     3840 tokens; 36 forward and 18 backward flash launches a step) and
     served text only (18 flash-decode launches a step);
 16. Whisper-small, 12 decoder and 12 encoder layers: trained at B=16,
     S=448 over 1500 float32 frames (60 forward and 36 backward flash
     launches a step) and served with caches filled by
     ``encode_to_cache`` (24 flash-decode launches a step, 12 in each form);
 17. time the flash kernels at PaliGemma's and Whisper's training shapes
     beside SDPA (its kernels printed by name) and the card's least time
     for the work (float32: 3xTF32 at the TF32 tensor-core peak, beside
     the FFMA bound);
 18. the flash kernels at RecurrentGemma-2B's training shape (B=1, S=4096
     past its 2048 window, MQA 10 over 1 KV head, D=256, bf16: the
     DMAX-256 wgmma kernels), absolutely and per band, with plain versions planted with
     windows of 2048 ± 64 caught; flash-decode's slot form at its serving
     shape (B=8, D=256, a 2048-slot ring that has wrapped), with a plain
     version planted with a window of 2048 - 64 caught;
 19. reduced RecurrentGemma (rglru, rglru, swa; window 32) in float32 on the
     CPU and on the card: every gradient of one batch agrees, 3 AdamW
     steps agree, and 48 lockstep decode steps past the window give the
     same tokens;
 20. RecurrentGemma-2B, all 26 layers: trained at B=1, S=4096 (16 forward
     and 8 backward flash launches a step; a profiled step's flash,
     ``rglru.scan``, GEMM and remaining shares) and decoded in lockstep
     through ``decode_step``, 8 lanes, 32 + 32 tokens (8 flash-decode
     launches a step);
 21. time the flash kernels at RecurrentGemma's shape with its window and
     causal only, beside SDPA and the card's least time for the work, and
     flash-decode at its serving shape;
 22. hold the SSD-scan forward and backward kernels against their plain
     versions in float32 and bfloat16 (y in x's type and in float32) at
     tests/test_kernels.py's sweep, N=128, one chunk, ragged sizes,
     Mamba2-780m's training shape, an odd head count, a state carried
     through 128 chunks and Bt x nc below and far above the SM count;
 23. train reduced Mamba-2 in float32 for 3 steps on the CPU and on the
     card: losses and weights agree; 12 lockstep decode steps agree;
 24. Mamba-2 training main path: full-width, full-depth Mamba2-780m, bf16,
     B=4, S=4096, remat, AdamW: one warm-up step, then 3 timed steps with
     finite loss and grad norm, changed weights and exactly 2 x layers
     forward and 1 x layers backward SSD-scan launches per step; one more
     step runs under torch.profiler;
 25. lockstep greedy decode of full Mamba2-780m through ``decode_step``
     (8 prompts of 32 tokens, 32 new tokens): valid tokens, float32 state,
     no flash-decode launch;
 26. time the SSD-scan kernels and their plain versions at the training
     shape beside the card's least time for the work, the forward's two
     and the backward's four phases apart (torch.profiler), and check that
     the bf16 forward and backward are each bit-identical when run twice;
 27. hold the prefix-scan kernel bit-equal to its plain version (torch.cumsum)
     on tests/test_prefix_scan.py's shapes, empty shapes, one row of 2^20,
     bool/uint8/int32 input, 3-D leading axes, strided and offset views and
     the sweep's (65536, 10000) block, then at the routes' boundaries
     (SCAN_LENGTHS x SCAN_ROWS in bool, uint8 and full-range int32, offset
     base pointers on every route), and show each route's kernel by name
     at a shape of that route; phases 28-38 and 42 print prefix_scan's
     launches by (rows, length, route) (``ScanHistogram``);
 28. the architecture zoo: for all 13 registered architectures the torch
     sweep on the card equals the port's numpy sweep on 4096 counter
     snapshots of 10,000 nodes at TP 16/32/64/24 in chunks of 8192, and on
     the first 256 of them in chunks of 1, on
     all-healthy and all-faulty rows and masks narrower and wider than the
     cluster; tpuv4's over-placement at TP-24 shows;
 29. Fig. 13 / Table 7: 1000 trace snapshots of 720 nodes, torch grids equal
     numpy, waste at TP-32 in the paper's bands and order;
 30. sweep main path (benchmarks/scale.py's configuration): 1,000,000
     counter snapshots of 10,000 nodes at 7%, TP-32, InfiniteHBD-K3 and
     NVL-72 through ``run_sweep(backend="torch")`` with masks drawn on the
     card in blocks of 65,536: snapshots/s, peak memory, mean waste, exactly
     2 prefix-scan launches per block, the first 16,384 rows equal to the
     host numpy path and to a chunk-8192 run; two blocks under
     torch.profiler, then the draw and the waste kernels each alone;
 31. time the prefix-scan kernel, its plain version and torch.cumsum at the
     sweep's block beside the bytes bound (CUDA graph over 4 inputs, the
     profiler's device time beside it);
 32. the Fig. 17c grid of benchmarks/dcn.py (2048 nodes, 512-node domains,
     five fault ratios x 100 snapshots, TP-32, three variants) through
     ``run_dcn_sweep(backend="torch")``: every grid equal to the port's
     numpy grid, the curves equal to BENCH_dcn.json, 26 prefix-scan
     launches;
 33. the DCN placement at datacenter scale: 8192 nodes, the five ratios x
     1024 snapshots, TP 32 and 64, orchestrated only, through
     ``run_dcn_sweep`` (launches: 4 * (iters + 1) + 2 = 30 per block and
     TP) and the kernel alone per TP (rows/s beside numpy's, every row
     equal to numpy), peak memory, a profile of one TP
     (busy and idle share, the scans' share beside their bytes bound), a
     fault planted in the card's input and a member changed in its output
     both caught; then the placement's scans timed at their short tier rows
     (64 entries) and full rows, as phase 31;
 34. churn: benchmarks/churn.py's 256-trace ensemble through
     ``monte_carlo_replay(backend="torch")``, batched and streamed, equal to
     numpy (traces/s); one 348-day trace of 2048 nodes through
     ``traffic_replay`` equal to numpy (rows/s); a control-plane replay on
     the host with its latency table;
 35. cost: benchmarks/cost.py's spec (768 nodes, ratios 0-15% x 200
     snapshots, TP 8 and 32, seed 5, 7 architectures) through
     ``run_cost_sweep(backend="torch")``: grids equal to numpy, Fig. 17d,
     Table 6 and the headline ratios equal to BENCH_cost.json, 24
     prefix-scan launches; the six ratios at 8192 nodes x 1024 snapshots,
     equal to numpy, rows/s and the card's busy share;
 36. matrix: benchmarks/matrix.py's ``comparison_matrix`` (512 nodes, 4
     ratios x 25 snapshots, TP-32, 12 architectures) with its waste and
     DCN sweeps on the card: rows equal to numpy and to BENCH_matrix.json
     at 6 decimals; then 8192 nodes x 256 snapshots, equal to numpy, the
     time of each span and the busy share;
 37. SLO: benchmarks/serve.py's spec (a 400-node, 60-day trace replayed on
     the card with its control plane at TP-16, host code, in a process of
     its own since the build; 3 streams, 6
     architectures): ``run_serve_sweep(backend="torch")`` equal to numpy
     and the scalar reference, 261,209 requests, slo_table equal to
     BENCH_serve.json; then the 348-day trace of 2048 nodes (37,791
     intervals) with 64 streams: the doubling scan equal to
     ``_scan_numpy``, requests/s of each;
 38. faults: each generator's ``torch_masks`` on the card equal to numpy at
     BENCH_faults.json's size, at the pinned digests and at 8192 nodes;
     then the JSON's scenario_table and claim_breaks rebuilt with the
     sweeps, replays, traffic replays and serving scans on the card, held
     to their scalar or numpy paths and equal to the JSON at its rounding;
 39. collectives on the card: 4 ranks of one torch.distributed world over
     gloo share the card (repro_torch.parallel.mesh.spawn_world); each runs
     the ring all-reduce (ring and psum), reduce-scatter, all-gather, the
     binary exchange and all_to_all_baseline on CUDA float32 and int32
     payloads of (2048, 4096), phase 40's MoE output, held to host
     references (the rings bit for bit in their order of adds, integers
     exactly), and gpipe over the 4 ranks at width 4096 against the stages
     in sequence; ms per call by rank;
 40. Mixtral-8x7B at full width and PAR_LAYERS (1) layer, sharded over the
     same 4 ranks, B=1, S=2048 a data shard; the unsharded port computed
     here first.  In float32 at mesh (data=1, model=4): tp mode with
     ar_impl "psum" and "ring", each rank's hidden states, loss and every
     gradient against the unsharded port's; at capacity factor 16 ep mode
     with the binary exchange and with all_to_all_single against tp mode
     (hidden states and loss); at mesh (data=2, model=2) tp mode, each
     data shard's hidden states, and the loss and every gradient averaged
     over data (sync_gradients) against the unsharded port's on both
     batches.
     In bf16 (PAR_TOL): at mesh (data=2, model=2) the loss and gradient
     norm averaged over data against the unsharded port's on both batches;
     at (data=1, model=4) the dropped shares of tp and ep mode at the
     config's capacity factor, then the main path, one AdamW step through make_train_step (4 forward and
     2 backward flash launches a rank; its loss, gradient norm and the loss
     after it against the unsharded step's) with each rank's ms;
 41. elastic restart: ElasticRunner training reduced H2O-Danube on the
     card under a fault at step 9 on nodes {3, 4} (64 nodes x 4 GPUs, TP
     16, DP 14, a checkpoint every 5 steps, 18 steps): one fault event, a
     settle time under 10 ms, the new DP degree, a checkpoint on disk, and
     the steps recomputed after the restore equal to the first pass's;
     then a straggler schedule flags node 5 and rebuilds as a fault;
 42. the engines with the snapshot axis split into 4 slices of the card
     (``device=["cuda:0"] * 4``, a CUDA stream each) against one slice: a
     131,072-snapshot counter sweep at 10,000 nodes (TP-32, blocks of
     65,536) equal to the one-slice run on every row and to numpy on the
     first 16,384; the Fig. 17c DCN grid equal to numpy and BENCH_dcn.json;
     benchmarks/cost.py's spec equal to phase 35's one-device grids; rows/s,
     the card's busy share and prefix_scan launched by every slice;
 43. sequence parallelism and FSDP: StarCoder2-3B at full width and 4
     layers, bf16, B=1, S=4096 a data shard, AdamW, over the 4 ranks of
     phase 39 under four rule sets ((1, 4) with seq_sp unmapped, (1, 4)
     and (2, 2) with the default rules' sequence parallelism, (2, 2) with
     fsdp mapped to data too): each rank's state and peak allocated
     memory, ms a step, flash launches, and the loss and gradient norm
     against the unsharded port's on the same batches; then float32 at 2
     layers, (2, 2), SP + FSDP: hidden states, the data-mean loss and every
     gradient against the unsharded port's.

 44. recurrent layers under a model axis: Mamba2-780m (4 layers, 12 SSD
     heads a rank) and RecurrentGemma-2B (3 layers: RG-LRU and local
     attention) at full width, B=1, S=2048 a data shard, over the 4 ranks:
     float32 at (1, 4), each rank's hidden states, loss and every gradient
     after sync_gradients against the unsharded port's, with the SSD and
     flash launches of the step; bf16 at (2, 2), 3 adamw_lowmem steps'
     losses and gradient norms against the unsharded steps' on both data
     shards' batches;
 45. the dry run against the card: phase 43's StarCoder2-3B step under its
     four rule sets traced on meta tensors as rank 0 of a fake 4-rank
     world (repro_torch.launch.dryrun, in a process of its own) and run
     for real on the 4 ranks under the same op analysis: predicted
     argument bytes equal to the bytes the setup requested of the caching
     allocator (and, rounded to its 512-byte blocks, printed beside what it
     allocated), FLOPs, collectives and kernel launches equal to the real
     run's, the predicted temp bytes printed beside max_memory_allocated;
     then the dry run of four production cells of the 256-rank mesh
     (started beside phase 44 in a process of its own), each one's seconds
     and per-rank bytes beside the card's total_memory;
 46. decode under a mesh, in phase 45's world of 4 ranks after phase 45's
     runs, each run against the unsharded port with the same weights: StarCoder2-3B at 8 layers, bf16,
     (1, 4), 8 lanes fed 32 prompt tokens and 32 greedy ones through
     decode_step (token agreement, ms a step, 8 decode_attention launches a
     rank and step); at 2 layers in float32 at (1, 4), and under kvdedup
     (KV heads unpadded, the cache's sequence over model): tokens equal,
     each rank's cache shard within DEC_TOL of its norm; Mamba2-780m (8
     layers) and RecurrentGemma-2B (6) in float32 at (1, 4), 8 lanes, 16
     steps: tokens and state shards; one lane at (4, 1) with the cache's
     sequence over data (long_500k's layout): StarCoder2-3B over 32,768
     slots filled from a seed below 32,760, 8 steps in float32 and bf16,
     and Mixtral-8x7B at one layer over its 4096-slot window wrapped, the
     writing rank moving from rank 0 to 1 (the written k/v rows, every
     position, the merge's ms); then the dry run of the bf16 step (a child
     process) against the step: argument bytes equal to the allocator's
     requested bytes, FLOPs, collectives and launches equal.  Phase 2
     also holds flash-decode's log-sum-exp form (float32 output and lse)
     to its plain version, rows with no valid slot included (bf16 cases on
     the reference's own scale, LSE_TOL, which a plain version without
     one split of 8 must fail), and it is timed at long_500k's shard shape;
 47. Llama-4 Maverick at full width and 2 of its 48 layers with its MoE layer
     in ep mode (experts over the model axis, the shared expert over ff), in
     phase 45's world of 4 ranks after phase 46, mesh (1, 4), bf16, each
     rank drawing only its own shards leaf by leaf (ep_draw): the MoE layer's
     ep output with the shared expert, both exchanges, against the ep routed
     part plus the whole shared MLP on the replicated tokens (each row
     within EP_ROW_TOL of its RMS; a plant that adds only the rank's ff share
     must fail); the forward and loss at B=1, S=512 and capacity factor 128
     (no drops) against tp mode on the same weights (the share of rows
     within EP_ROW_TOL); 8 lanes decoded, 32 prompt + 32 greedy tokens, in
     both modes (token agreement, 2 decode_attention launches a rank and
     step); the dry run of ep mode's forward and decode step (a child
     process) against the measured ones: argument bytes equal to the
     allocator's requested bytes, FLOPs, collectives and launches equal;
     then reduced Llama-4 in float32 at capacity factor 4, ep at (1, 4):
     hidden states, loss and every gradient against the unsharded port;
 48. Mamba2-780m at full width and 12 of its 48 layers (RSERVE_LAYERS) and
     RecurrentGemma-2B at full depth and width, bf16, served through
     ServeEngine with its lane mask: 8 requests of 32 + 32 tokens at
     batch 8 admitted two engine steps apart, slots 6 and 7 paused by
     set_capacity for 4 steps and resumed, a ninth request in the slot the
     first to finish leaves: every request's stream bit-identical to an
     engine serving that request alone in the same slot, while the engine
     without the lane mask (repro's behaviour), through the first two
     admissions, must change some stream; ms a
     step, decode_attention launches (RecurrentGemma's 8 a step, slot form),
     a profile of engine steps (the device's idle share); before them the
     reduced configs in float32 through the same drive, card streams equal
     to the CPU's.

Phase 40 runs under the default rules, whose ``seq_sp`` maps to the model
axis, so it checks the sequence-parallel path: the MoE layer's gather and
split included.

The last lines are the script's time, the ``{"kernels": ...}`` record, the
card line and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import hashlib
import importlib
import json
import math
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Gradients of the flash-attention kernels against the plain version, as a
# share of the gradient's largest entry: dK and dV sum up to Sq * rep
# products (49k at StarCoder2's shape) in another order than the plain
# version, in fp32; in bf16 the stored gradient rounds to 8 bits.
GRAD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# The windowed bf16 flash cases at S = 8192 are also held to the reference's
# own scale: past a 4096 window a row averages ~1500 keys, so its outputs
# are ~0.026 and TOL's absolute 2e-2 would pass a window off by a tile.
# Per band of 64 sequence rows, the band's max abs error over the RMS of the
# reference in the band: the bf16 rounding of both sides reads up to 0.106
# on an H100 (largest in the first rows, which average few keys), and a
# plain version whose window is off by 64 keys reads 1.35 or more.  lse's
# max abs error: the plain version rounds q * scale to bf16, which moves the
# lse of a row with few keys by up to 4.7e-3; the window off by 64 keys
# moves it by 4e-2 or more.
WINDOW_TOL = {"band_rel": 0.3, "lse_abs": 1e-2}
WINDOW_BAND = 64
# The same per-band check in float32 (Whisper's encoder and cross-attention
# run in float32): both sides round in float32 and sum up to 1500 keys in
# another order, which reads ~1e-5 of a band's RMS; a key length off by one
# 64-key tile reads ~1 on out.
BAND_TOL = {"bfloat16": WINDOW_TOL, "float32": {"band_rel": 2e-4, "lse_abs": 1e-4}}
# Flash-decode's output over the RMS of the plain version's, where the
# attention averages up to 1500 keys and its outputs (~0.03) sit far below
# TOL's absolute 2e-2: bf16 rounding of the output reads a few 1e-3, and a
# key length off by one 64-key tile reads ~1.
DECODE_REL_TOL = 0.1
# Reduced training, card against CPU in float32: 3 AdamW steps move each
# weight by ~lr whatever its gradient's size, so an entry whose gradient
# differs in its last digits may move a little differently (as in
# tests/test_torch_train.py).
TRAIN_TOL = {"loss_rel": 1e-4, "param_abs": 1e-4}
# The SSD scan against its plain version: the tolerances of
# tests/test_kernels.py for y (atol = rtol); gradients as a share of the
# gradient's largest entry (dB and dC sum over every head and the chunk).
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
FP32_FLOPS = 67e12               # H100 SXM float32 peak outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM dense TF32 tensor-core peak
# The float32 flash kernels run each product as three TF32 products
# (3xTF32), so their least time is 3 x their FLOPs at TF32_FLOPS.
TF32_SPLIT = 3
# H100 SXM int32 adds on the CUDA cores: 64 a clock on each of 132 SMs at 1.98 GHz
INT32_OPS = 64 * 132 * 1.98e9
KERNELS = ["decode_attention", "flash_attention", "ssd_scan", "prefix_scan"]


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
            if "registers" in line or "spill" in line or "C7512" in line:
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
    if b > 1:
        lengths[1] = top
    return q, k, v, lengths


def ring_slots(torch, q_pos, w):
    """(B, W) slot positions of a ring cache after writing positions
    0..q_pos[b] of lane b into slot position % W (-1 = never written)."""
    j = torch.arange(w, device=q_pos.device, dtype=torch.int32)[None, :]
    t = q_pos[:, None] - torch.remainder(q_pos[:, None] - j, w)
    return torch.where(t >= 0, t, torch.full_like(t, -1)).to(torch.int32)


def slot_inputs(torch, seed, b, hq, hkv, d, w, qdt, kvdt, lo, hi, strided=False):
    """q (B, 1, Hq, D), k, v (B, W, Hkv, D), slot_pos, q_pos with q_pos drawn
    from [lo, hi); ``strided`` cuts k and v from wider tensors."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, hq, d), generator=gen, device="cuda").to(qdt)
    wide = 2 if strided else 1
    k = torch.randn((b, w, hkv, wide * d), generator=gen, device="cuda").to(kvdt)[..., :d]
    v = torch.randn((b, w, hkv, wide * d), generator=gen, device="cuda").to(kvdt)[..., -d:]
    q_pos = torch.randint(lo, hi, (b,), generator=gen, device="cuda", dtype=torch.int32)
    return q, k, v, ring_slots(torch, q_pos, w), q_pos


def decode_path(torch, b, hq, hkv, s):
    """(plan, words): how flash-decode splits a call of q (b, hq, D) over
    ``s`` slots and ``hkv`` KV heads on card 0, and merges the splits."""
    from repro_torch.kernels.decode_attention.decode_attention import plan

    pl = plan(b, hq, hkv, s, torch.cuda.get_device_properties(0).multi_processor_count)
    if pl.merge == "cluster":
        how = "in one cluster"
    elif pl.group == pl.n_split:
        how = "through memory in one step"
    else:
        how = f"through memory in groups of {pl.group}, then the groups"
    return pl, f"{pl.n_split} splits of {pl.split_keys} keys a row, merged {how}"


def check_decode_attention(torch):
    """Both masks of the decode kernel against their plain versions, and a
    bit-identical repeat of a call whose splits the kernel merges, in a
    cluster and through device memory.  The few-row cases (rows whose splits
    merge through device memory, and their neighbours) are also held to
    FEW_ROW_TOL on each row's error over the plain version's row RMS, and a
    row with no valid key must give zeros."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_cache,
                                                      decode_attention_cache_ref,
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
        # splits of 17,536 keys: each block streams two passes of <= 16,384
        ("S=140000 bf16, two passes a split", 3, 24, 2, 128, 140000, bf, bf, None),
        ("S=140000 f32, two passes a split", 3, 24, 2, 128, 140000, f32, f32, None),
    ]
    # (label, B, Hq, Hkv, D, W, q dtype, cache dtype, q_pos range, window, chunk, strided)
    slot_cases = [
        ("wrapped rep 12", 8, 24, 2, 128, 1024, bf, bf, (1024, 4000), 0, 0, False),
        ("wrapped rep 12 f32", 8, 24, 2, 128, 1024, f32, f32, (1024, 4000), 0, 0, False),
        ("short lanes, empty slots", 8, 24, 2, 128, 1024, bf, bf, (0, 200), 0, 0, False),
        ("window 300", 8, 24, 2, 128, 1024, bf, bf, (0, 3000), 300, 0, False),
        ("chunk 200", 8, 24, 2, 128, 1024, bf, bf, (0, 3000), 0, 200, False),
        ("window 100 chunk 256 W=512", 4, 24, 2, 128, 512, bf, bf, (0, 2000), 100, 256, False),
        ("D=80 rep 4 (H2O-Danube)", 4, 32, 8, 80, 1000, bf, bf, (0, 2500), 0, 0, False),
        ("D=96 rep 1 (GPT-MoE)", 4, 8, 8, 96, 1000, bf, bf, (0, 2500), 0, 0, False),
        ("D=256 rep 16", 4, 16, 1, 256, 700, bf, bf, (0, 1500), 0, 0, False),
        ("D=256 rep 16 f32", 4, 16, 1, 256, 700, f32, f32, (0, 1500), 0, 0, False),
        ("D=64 rep 16", 4, 32, 2, 64, 1024, bf, bf, (500, 3000), 0, 0, False),
        ("rep 20, two head groups", 2, 40, 2, 128, 600, bf, bf, (0, 1500), 0, 0, False),
        ("D=40 CUDA cores", 4, 12, 3, 40, 777, bf, bf, (0, 2000), 0, 0, False),
        ("f32 q, bf16 cache D=80", 4, 32, 8, 80, 1000, f32, bf, (0, 2500), 0, 0, False),
        ("strided cache views", 4, 24, 2, 128, 1024, bf, bf, (0, 3000), 0, 0, True),
        ("strided f32", 4, 8, 2, 64, 333, f32, f32, (0, 900), 50, 0, True),
        ("wrapped W=140000, two passes a split", 2, 24, 2, 128, 140000, bf, bf,
         (140000, 400000), 0, 0, False),
        ("W=140000 window 3000 f32, passes with no live tile", 2, 8, 2, 64, 140000, f32, f32,
         (150000, 400000), 3000, 0, False),
    ]
    errs = {"float32": 0.0, "bfloat16": 0.0, "slots": 0.0}

    def judge(label, out, ref, qdt, kvdt, slots):
        key = "bfloat16" if bf in (qdt, kvdt) else "float32"
        tol = TOL[key]
        err = (out.float() - ref.float()).abs().max().item()
        ok = out.dtype == qdt and out.shape == ref.shape and torch.allclose(
            out.float(), ref.float(), atol=tol, rtol=tol)
        print(f"decode_attention {'slots ' if slots else ''}{label}: max_abs_err {err:.3e} "
              f"(tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention disagrees with its plain version on "
                                 f"{label}: max abs err {err}")
        errs[key] = max(errs[key], err)
        if slots:
            errs["slots"] = max(errs["slots"], err)

    for seed, (label, b, hq, hkv, d, s, qdt, kvdt, top) in enumerate(cases):
        q, k, v, lengths = attention_inputs(torch, seed, b, hq, hkv, d, s, qdt, kvdt, top)
        out = decode_attention(q, k, v, lengths)
        ref = decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        judge(label, out, ref, qdt, kvdt, False)
    for seed, (label, b, hq, hkv, d, w, qdt, kvdt, (lo, hi), win, chk, strided) in \
            enumerate(slot_cases):
        q, k, v, sp, qp = slot_inputs(torch, 50 + seed, b, hq, hkv, d, w, qdt, kvdt, lo, hi,
                                      strided)
        out = decode_attention_cache(q, k, v, sp, qp, window=win, chunk=chk)
        ref = decode_attention_cache_ref(q, k, v, sp, qp, window=win, chunk=chk)
        torch.cuda.synchronize()
        judge(label, out, ref, qdt, kvdt, True)
    def judge_rows(label, out, ref, qdt, kvdt, live, slots):
        judge(label, out[live], ref[live], qdt, kvdt, slots)
        rel = lse_row_rel(out[live], ref[live])
        tol = FEW_ROW_TOL["bfloat16" if out.dtype == bf else "float32"]
        zeros = bool((out[~live] == 0).all())
        ok = rel <= tol and zeros
        print(f"decode_attention {'slots ' if slots else ''}{label}: over the reference's row "
              f"RMS {rel:.3e} (tol {tol}); {int((~live).sum())} rows with no "
              f"valid key give zeros: {zeros} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention disagrees with its plain version on {label}")

    # few rows: (label, B, Hq, Hkv, D, S, q dtype, cache dtype, lengths)
    few = [
        ("long_500k shard, every key", 1, 3, 1, 128, 32768, bf, bf, [32768]),
        ("long_500k shard f32, every key", 1, 3, 1, 128, 32768, f32, f32, [32768]),
        ("long_500k shard, keys in split 0 only", 1, 3, 1, 128, 32768, bf, bf, [100]),
        ("S=30001, not a whole number of splits, a row with no key", 3, 3, 1, 128, 30001, bf,
         bf, [30001, 17777, 0]),
        ("S=30001 f32, a row with no key", 3, 3, 1, 128, 30001, f32, f32, [0, 30001, 5]),
    ]
    for seed, (label, b, hq, hkv, d, s, qdt, kvdt, lens) in enumerate(few):
        q, k, v, lengths = attention_inputs(torch, 300 + seed, b, hq, hkv, d, s, qdt, kvdt)
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        out = decode_attention(q, k, v, lengths)
        ref = decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        path = decode_path(torch, b, hq, hkv, s)[1]
        judge_rows(f"{label} (B={b} Hq={hq} Hkv={hkv} D={d} S={s}; {path})", out, ref, qdt,
                   kvdt, lengths > 0, False)
    # (label, B, Hq, Hkv, D, W, q dtype, cache dtype, q_pos range, window)
    few_slots = [
        ("long_500k shard, wrapped", 1, 3, 1, 128, 32768, bf, bf, (32768, 90000), 0),
        ("long_500k shard f32, wrapped", 1, 3, 1, 128, 32768, f32, f32, (32768, 90000), 0),
        ("long_500k shard, q_pos early: keys in split 0 only", 1, 3, 1, 128, 32768, bf, bf,
         (0, 100), 0),
        ("W=30001 window 3000: few live splits, the last one short", 2, 3, 1, 128, 30001, bf,
         bf, (40000, 90000), 3000),
        ("RecurrentGemma 10/1 D=256, wrapped, window 2048", 8, 10, 1, 256, 2048, bf, bf,
         (2048, 8192), 2048),
        ("RecurrentGemma 10/1 D=256 f32, wrapped, window 2048", 8, 10, 1, 256, 2048, f32, f32,
         (2048, 8192), 2048),
        ("RecurrentGemma 10/1 D=256, short lanes", 8, 10, 1, 256, 2048, bf, bf, (0, 300), 2048),
        ("PaliGemma 8/1 D=256 W=1024", 8, 8, 1, 256, 1024, bf, bf, (0, 2500), 0),
        ("PaliGemma 8/1 D=256 W=4096", 8, 8, 1, 256, 4096, bf, bf, (0, 9000), 0),
    ]
    for seed, (label, b, hq, hkv, d, w, qdt, kvdt, (lo, hi), win) in enumerate(few_slots):
        q, k, v, sp, qp = slot_inputs(torch, 320 + seed, b, hq, hkv, d, w, qdt, kvdt, lo, hi)
        out = decode_attention_cache(q, k, v, sp, qp, window=win)
        ref = decode_attention_cache_ref(q, k, v, sp, qp, window=win)
        torch.cuda.synchronize()
        path = decode_path(torch, b, hq, hkv, w)[1]
        judge_rows(f"{label} (B={b} Hq={hq} Hkv={hkv} D={d} W={w}; {path})", out, ref, qdt,
                   kvdt, torch.ones(b, dtype=torch.bool, device="cuda"), True)
    errs["lse"] = check_lse_form(torch)
    # the splits merge in split order, not arrival order: the same bits twice,
    # in a cluster and through device memory (long_500k's shard in the
    # log-sum-exp form, RecurrentGemma's ring)
    q, k, v, lengths = attention_inputs(torch, 90, 8, 24, 2, 128, 4096, bf, bf, None)
    q2, k2, v2, sp, qp = slot_inputs(torch, 91, 8, 24, 2, 128, 1024, bf, bf, 1024, 4000)
    q3, k3, v3, sp3, qp3 = slot_inputs(torch, 92, 1, 3, 1, 128, 32768, bf, bf, 32768, 90000)
    dc = RECURRENTGEMMA_DECODE
    q4, k4, v4, sp4, qp4 = slot_inputs(torch, 93, dc["b"], dc["hq"], dc["hkv"], dc["d"],
                                       dc["w"], bf, bf, dc["w"], 4 * dc["w"])
    repeats = {
        "S=4096, bf16": lambda: decode_attention(q, k, v, lengths),
        "wrapped W=1024, bf16": lambda: decode_attention_cache(q2, k2, v2, sp, qp),
        "long_500k shard, lse form": lambda: torch.cat(
            [t.flatten() for t in decode_attention_cache(q3, k3, v3, sp3, qp3,
                                                         return_lse=True)]),
        "RecurrentGemma's ring": lambda: decode_attention_cache(q4, k4, v4, sp4, qp4,
                                                                window=dc["w"]),
    }
    paths = [decode_path(torch, *a)[1] for a in ((8, 24, 2, 4096), (8, 24, 2, 1024),
                                                 (1, 3, 1, 32768),
                                                 (dc["b"], dc["hq"], dc["hkv"], dc["w"]))]
    for (label, f), path in zip(repeats.items(), paths):
        same = torch.equal(f(), f())
        print(f"decode_attention {label} ({path}), run twice: "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"decode_attention is not deterministic on {label}")
    return errs


# The log-sum-exp form (label, B, Hq, Hkv, D, W, q dtype, cache dtype, q_pos
# range, window, chunk, lanes emptied): long_500k's shard on one rank of
# Llama-4's global layer (B=1, Hq=3, Hkv=1, D=128, 32,768 slots) and the
# shapes of the sharded decode phases, with lanes whose slots are all
# empty (-1) or all after the query (a shard that holds no valid slot).
LSE_CASES = [
    ("long_500k shard, bf16", 1, 3, 1, 128, 32768, "bfloat16", "bfloat16", (32768, 90000),
     0, 0, 0),
    ("long_500k shard, f32", 1, 3, 1, 128, 32768, "float32", "float32", (32768, 90000),
     0, 0, 0),
    ("StarCoder2 kvdedup shard, bf16, empty lanes", 8, 24, 2, 128, 256, "bfloat16",
     "bfloat16", (0, 1000), 0, 0, 3),
    ("StarCoder2 shard f32, empty lanes", 8, 24, 2, 128, 8192, "float32", "float32",
     (0, 30000), 0, 0, 3),
    ("Mixtral window shard, bf16, empty lanes", 4, 32, 8, 128, 1024, "bfloat16", "bfloat16",
     (0, 20000), 4096, 0, 2),
    ("chunk 200, f32 q over a bf16 cache, empty lanes", 4, 16, 2, 64, 512, "float32",
     "bfloat16", (0, 3000), 0, 200, 2),
    ("long_500k shard, q_pos early: keys in split 0 only, bf16", 1, 3, 1, 128, 32768,
     "bfloat16", "bfloat16", (0, 100), 0, 0, 0),
    ("long_500k shard, no valid slot, bf16", 1, 3, 1, 128, 32768, "bfloat16", "bfloat16",
     (32768, 90000), 0, 0, 1),
    ("W=30001 f32, not a whole number of splits, an empty lane", 2, 3, 1, 128, 30001,
     "float32", "float32", (30001, 90000), 0, 0, 1),
    ("RecurrentGemma's ring, window 2048, bf16, an empty lane", 8, 10, 1, 256, 2048,
     "bfloat16", "bfloat16", (2048, 8192), 2048, 0, 1),
]


# The bf16 cases of the log-sum-exp form on the reference's own scale: at
# long_500k's shard a row averages 32,768 keys and its outputs are ~0.009,
# under TOL's absolute 2e-2.  Each row's max abs error over the RMS of the
# plain version's row: the kernel rounds the probabilities to bf16 for the
# tensor cores and both sides sum in float32, which reads a few 1e-3; a
# merge that drops the last of the kernel's 256 splits (128 keys) reads
# ~0.16 (4096 keys, one of 8: ~1.1).  lse's max abs error: both sides take
# it from the same bf16 inputs in float32 (~1e-6); one split of 256 dropped
# moves it by log(256/255) = 0.004, a window off by a 64-key tile of 1024
# keys by 0.06.
LSE_TOL = {"out_rel": 2e-2, "lse_abs": 1e-3}
# The few-row cases of both masks (check_decode_attention) on the same
# scale, by the output's type: a float32 output within LSE_TOL's 2e-2; a
# bf16 one within 4e-2, since both sides round to bf16 and may land one ulp
# apart, up to 2^-7 of an entry that can be ~3.5x its row's RMS (~0.027).
# A merge that drops one split of 256 reads ~0.16, one of 16 far more.
FEW_ROW_TOL = {"float32": 2e-2, "bfloat16": 4e-2}


def lse_row_rel(out, ref):
    """The largest over rows (B, 1, Hq) of a row's max abs error over the
    RMS of the plain version's row."""
    err = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().square().mean(-1).sqrt()
    return (err / rms).max().item()


def check_lse_form(torch):
    """``decode_attention_cache(..., return_lse=True)`` against its plain
    version on every row with a valid slot: float32 cases within TOL
    absolutely and relatively, bf16 ones within LSE_TOL of the reference's
    scale; a row with none gives zeros and -inf (the plain version -1e30 +
    log W beside the mean of V, either weighing 0 in a merge); the output
    rounded to q's type is the plain launch's, bit for bit.  At long_500k's
    shard a plain version that drops the last of the kernel's splits (as
    many as ``decode_path`` says) must go over LSE_TOL.  Returns the largest
    error."""
    from repro_torch.kernels.decode_attention import (decode_attention_cache,
                                                      decode_attention_cache_ref)

    worst = 0.0
    for seed, (label, b, hq, hkv, d, w, qd, kvd, (lo, hi), win, chk, empty) in \
            enumerate(LSE_CASES):
        qdt, kvdt = getattr(torch, qd), getattr(torch, kvd)
        q, k, v, sp, qp = slot_inputs(torch, 200 + seed, b, hq, hkv, d, w, qdt, kvdt, lo, hi)
        if empty:
            sp[0] = -1                             # never written
            sp[1:empty] = qp[1:empty, None] + 1    # every slot after the query
        kw = dict(window=win, chunk=chk)
        out, lse = decode_attention_cache(q, k, v, sp, qp, return_lse=True, **kw)
        plain = decode_attention_cache(q, k, v, sp, qp, **kw)
        ref, ref_lse = decode_attention_cache_ref(q, k, v, sp, qp, return_lse=True, **kw)
        torch.cuda.synchronize()
        bf16 = torch.bfloat16 in (qdt, kvdt)
        live = torch.ones(b, dtype=torch.bool, device="cuda")
        live[:empty] = False
        err = lerr = rel = 0.0
        if bool(live.any()):
            err = (out[live] - ref[live]).abs().max().item()
            lerr = (lse[live] - ref_lse[live]).abs().max().item()
            rel = lse_row_rel(out[live], ref[live])
        if bf16:
            close = rel <= LSE_TOL["out_rel"] and lerr <= LSE_TOL["lse_abs"]
            limits = (f"over the reference's row RMS {rel:.3e} (tol {LSE_TOL['out_rel']}), "
                      f"lse {lerr:.3e} (tol {LSE_TOL['lse_abs']})")
        else:
            tol = TOL["float32"]
            close = (torch.allclose(out[live], ref[live], atol=tol, rtol=tol)
                     and torch.allclose(lse[live], ref_lse[live], atol=tol, rtol=tol))
            limits = f"lse {lerr:.3e} (tol {tol}); over the reference's row RMS {rel:.3e}"
        ok = (out.dtype == torch.float32 and lse.dtype == torch.float32
              and out.shape == (b, 1, hq, d) and lse.shape == (b, hq) and close
              and bool((out[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
              and bool((ref_lse[~live] <= -1e29).all())
              and torch.equal(out.to(qdt), plain))
        pl, path = decode_path(torch, b, hq, hkv, w)
        print(f"decode_attention lse form {label} ({path}): out max_abs_err {err:.3e}, {limits}; "
              f"{empty} empty lanes give zeros and -inf; out in {qd} equals the plain "
              f"launch's: {torch.equal(out.to(qdt), plain)} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention's lse form disagrees on {label}")
        if seed == 0:
            # the plain version without the last split's keys (all of them valid here)
            cut = sp.clone()
            cut[:, (pl.n_split - 1) * pl.split_keys:] = -1
            bad, bad_lse = decode_attention_cache_ref(q, k, v, cut, qp, return_lse=True, **kw)
            bad_rel = lse_row_rel(out, bad)
            bad_l = (lse - bad_lse).abs().max().item()
            print(f"decode_attention lse form {label}: the plain version planted without the "
                  f"last of {pl.n_split} splits ({w - (pl.n_split - 1) * pl.split_keys} keys): "
                  f"over its row RMS {bad_rel:.3e}, lse {bad_l:.3e}")
            if bad_rel <= LSE_TOL["out_rel"] or bad_l <= LSE_TOL["lse_abs"]:
                raise AssertionError("the lse-form check passes a merge that drops a split")
        worst = max(worst, err, lerr)
    return worst


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
        # prompts longer than the cache wrap its ring of max_len slots
        eng = ServeEngine(cfg, model, max_batch=2, max_len=8, device=dev)
        streams[dev] += [r.out for r in serve(eng, Request, cfg.vocab_size,
                                              3, 10, 6, seed=3)]
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"reduced model: card {streams['cuda']} != "
                             f"cpu {streams['cpu']}")
    print(f"reference: reduced {cfg.name}, float32 weights, 3 requests and 3 with "
          f"10-token prompts over max_len 8: card token streams equal the CPU plain "
          f"path's")


def depth(cfg) -> str:
    """The layer count, and the published one where the depth was cut."""
    from repro_torch.configs import ARCHS

    full = ARCHS[cfg.name].num_layers if cfg.name in ARCHS else cfg.num_layers
    return (f"{cfg.num_layers} layers" if cfg.num_layers == full else
            f"{cfg.num_layers} of {full} layers (depth cut, widths published)")


def serve_full(torch, cfg=None):
    """Serving main path: a full-width config (StarCoder2-3B unless ``cfg``
    is given) with random bf16 weights serves 8 requests of 32 + 32 tokens;
    every request finishes and each decode step launches flash-decode once
    per layer, and once more per layer with cross-attention.  An MoE config
    also prints its dropped expert assignments.  An encoder-decoder config's
    engines get their cache filled by ``encode_to_cache`` over float32 stub
    frames, one utterance a lane, before any request."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import encode_to_cache, init_params
    from repro_torch.serve import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg or get_arch("starcoder2")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"model: {cfg.name}, {depth(cfg)}, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B parameters, {weight_bytes / 1e9:.3f} GB of weights, "
          f"made in {time.perf_counter() - t0:.2f} s")

    batch, max_len, n_req, prompt_len, max_new = 8, 1024, 8, 32, 32
    frames = None
    if cfg.is_encdec:
        frames = torch.randn((batch, cfg.enc_seq, cfg.d_model), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(5)) * 0.02
    warm = ServeEngine(cfg, model, max_batch=batch, max_len=max_len)
    if frames is not None:
        warm.cache = encode_to_cache(model, warm.cache, frames)
    serve(warm, Request, cfg.vocab_size, 1, 4, 3, seed=99)
    del warm

    eng = ServeEngine(cfg, model, max_batch=batch, max_len=max_len)
    # what a decode step must read: the decoder's weights and, with
    # cross-attention, every layer's encoder K/V
    step_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                     if not n.startswith("enc."))
    if frames is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.cache = encode_to_cache(model, eng.cache, frames)
        torch.cuda.synchronize()
        xk = eng.cache[0]["xk"]
        cross_bytes = sum(c[n].numel() * c[n].element_size() for c in eng.cache
                          for n in ("xk", "xv"))
        step_bytes += cross_bytes
        print(f"serve: {cfg.name}: cache filled by encode_to_cache over {batch} utterances "
              f"of {cfg.enc_seq} float32 frames in {(time.perf_counter() - t0) * 1e3:.1f} ms: "
              f"xk/xv {tuple(xk.shape)} {xk.dtype} in each of {cfg.num_layers} layers "
              f"({cross_bytes / 1e9:.3f} GB), self-attention cache {eng.cache[0]['k'].dtype}")
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
    per_step = attention_layers(cfg) * (2 if cfg.is_encdec else 1)
    if launches != per_step * steps:
        raise AssertionError(f"decode_attention launched {launches} times in "
                             f"{steps} decode steps of {per_step} attention calls")
    tokens = sum(len(r.out) for r in reqs)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"serve: {cfg.name}: {n_req} requests, {tokens} tokens, {steps} decode steps "
          f"({prefill_steps} prefill + {decode_steps} engine steps), "
          f"{tokens / (t2 - t0):.1f} tok/s overall, "
          f"{(t2 - t0) / steps * 1e3:.3f} ms per decode step overall, "
          f"{(t1 - t0) / prefill_steps * 1e3:.3f} ms per prefill step, "
          f"{(t2 - t1) / decode_steps * 1e3:.3f} ms per engine step "
          f"({n_req * decode_steps / (t2 - t1):.1f} tok/s), "
          f"{'weight and encoder-cache' if frames is not None else 'weight'}-streaming "
          f"bound {bound_ms:.3f} ms per step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"serve: {cfg.name}: decode_attention launches {launches} = {per_step} x {steps} "
          f"steps" + (f" ({cfg.num_layers} slot form and {cfg.num_layers} lengths form a "
                      f"step)" if cfg.is_encdec else ""))
    if cfg.n_experts:
        # every lane of the batch, idle ones too, is routed (as in repro), so
        # the capacity of a step is max(1, int(capacity_factor * 8 * top_k / E))
        cap = max(1, int(cfg.capacity_factor * batch * cfg.top_k / cfg.n_experts))
        print(f"serve: {cfg.name}: {counters['moe.dropped_assignments']} of "
              f"{counters['moe.assignments']} expert assignments dropped over {steps} "
              f"steps ({cfg.n_experts} experts, top-{cfg.top_k}, capacity {cap} a step; "
              f"uniformly drawn prompts)")
    profile_engine_steps(torch, eng)
    return {"launches": launches, "steps": steps,
            "ms_per_step": (t2 - t1) / decode_steps * 1e3}


# ------------------------------------------------------------ timing


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


def decode_bufs(torch, s, max_len=None, slots=False, b=8, hq=24, hkv=2, d=128):
    """Kernel arguments of B=8 StarCoder2 heads over a bf16 cache of S slots,
    on enough caches to exceed the 50 MB L2, as 30 layers do: all live or
    random lengths up to ``max_len``; with ``slots`` ring caches in the slot
    form, wrapped (every slot valid) or filled below positions up to
    ``max_len``, as the serve path leaves them."""
    bf = torch.bfloat16
    kv_bytes = 2 * b * s * hkv * d * 2
    n_buf = max(2, math.ceil(120e6 / kv_bytes))
    if slots:                   # wrapped, or positions below max_len
        lo, hi = (0, max_len) if max_len else (s, 4 * s)
        return [slot_inputs(torch, 100 + i, b, hq, hkv, d, s, bf, bf, lo, hi)
                for i in range(n_buf)]
    bufs = [attention_inputs(torch, 100 + i, b, hq, hkv, d, s, bf, bf, max_len)
            for i in range(n_buf)]
    lengths = bufs[0][3]
    if max_len is None:                              # every slot live
        lengths.fill_(s)
    return [(q, k, v, lengths) for q, k, v, _ in bufs]


def time_decode_attention(torch, label, s, max_len=None, slots=False, hq=24, hkv=2, d=128,
                          window=0, b=8, lse=False):
    """Kernel, plain version and SDPA at B=8 StarCoder2 heads (or ``b``
    lanes of ``hq`` query heads over ``hkv`` KV heads of ``d``), bf16, over
    a cache of S slots (see ``decode_bufs``); the slot form masks by
    ``window``, and with ``lse`` runs its log-sum-exp form (float32 output
    and lse; SDPA computes the output alone)."""
    import functools

    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    bufs = decode_bufs(torch, s, max_len, slots, b, hq, hkv, d)
    n_buf = len(bufs)
    if slots:
        from repro_torch.kernels.decode_attention import (decode_attention_cache,
                                                          decode_attention_cache_ref)
        from repro_torch.kernels.decode_attention.ref import slot_mask

        masks = [slot_mask(sp, qp, window)[:, None, None, :] for _, _, _, sp, qp in bufs]
        sdpa_in = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
                   for q, k, v, _, _ in bufs]
        live = sum(int(m.sum().item()) for m in masks) // n_buf
        kernel_fn, plain_fn = (functools.partial(f, window=window, **({"return_lse": True}
                                                                      if lse else {}))
                               for f in (decode_attention_cache, decode_attention_cache_ref))
    else:
        lengths = bufs[0][3]
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        masks = [mask] * n_buf
        sdpa_in = [(q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2))
                   for q, k, v, _ in bufs]
        live = int(lengths.sum().item())
        kernel_fn, plain_fn = decode_attention, decode_attention_ref

    def kernel(i):
        return kernel_fn(*bufs[i])

    def plain(i):
        return plain_fn(*bufs[i])

    def library(i):
        return F.scaled_dot_product_attention(*sdpa_in[i], attn_mask=masks[i],
                                              enable_gqa=True)

    kernel_ms = graph_ms(torch, kernel, n_buf)
    kernel_eager_ms = eager_ms(torch, kernel, n_buf)
    calls = iter(range(10**9))
    device_ms = kernel_ms_by_group(torch, lambda: kernel(next(calls) % n_buf), 20,
                                   {"decode": "decode"})["decode"]
    plain_ms = graph_ms(torch, plain, n_buf, iters=5)
    library_ms = graph_ms(torch, library, n_buf)
    library_eager_ms = eager_ms(torch, library, n_buf)
    nbytes = (2 * live * hkv * d * 2          # the K and V rows the step needs
              + b * hq * d * 2                # q
              + b * hq * (d * 4 + 4 if lse else d * 2)     # out (float32 and lse)
              + (b * s * 4 + b * 4 if slots else b * 4))   # slot positions or lengths
    ops = 4 * live * hq * d
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOPS else "operations"
    pl, path = decode_path(torch, b, hq, hkv, s)
    print(f"time decode_attention {label}{' (lse form)' if lse else ''}: B={b} Hq={hq} "
          f"Hkv={hkv} D={d} S={s} ({path}) "
          f"window {window}, live keys {live}, bf16: kernel {kernel_ms * 1e3:.2f} us on the card "
          f"({nbytes / kernel_ms / 1e6:.0f} GB/s; {device_ms * 1e3:.2f} us of kernel time "
          f"in torch.profiler), {kernel_eager_ms * 1e3:.2f} us eager; bound {bound_ms * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB); "
          f"plain {plain_ms * 1e3:.2f} us; sdpa {library_ms * 1e3:.2f} us on the "
          f"card, {library_eager_ms * 1e3:.2f} us eager")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms, "profiler_ms": device_ms,
            "eager_ms": kernel_eager_ms, "library_eager_ms": library_eager_ms,
            "n_split": pl.n_split, "merge": pl.merge}


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
    return summarize_profile(torch, prof, wall_ms, n_steps,
                      f"{eng.cfg.name}: {n_steps} engine steps of batch {eng.max_batch}",
                      {"flash-decode": "decode_", "cuBLAS GEMM": "nvjet"})


def summarize_profile(torch, prof, wall_ms, n_steps, label, groups):
    """Print device busy time and idle share per step, the kernel count and
    the kernels that took the most time; ``groups`` maps a label to a
    substring of kernel names whose time is summed."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("profile: the profiler recorded no device kernels")
        return None
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    parts = ", ".join(
        f"{g} {sum(t for n, t in by_name.items() if sub in n) / 1e3 / n_steps:.3f} ms"
        for g, sub in groups.items())
    idle = 100 * (1 - busy / 1e3 / wall_ms)
    print(f"profile: {label}: {wall_ms / n_steps:.3f} ms per step under the profiler, "
          f"device busy {busy / 1e3 / n_steps:.3f} ms per step ({idle:.1f}% idle), "
          f"{len(kernels) / n_steps:.0f} kernels per step, {parts} per step")
    for name, t in top:
        print(f"profile: {t / 1e3 / n_steps:8.3f} ms per step  {name[:100]}")
    return {"busy_ms": busy / 1e3 / n_steps, "idle_pct": idle,
            "groups": {g: sum(t for n, t in by_name.items() if sub in n) / 1e3 / n_steps
                       for g, sub in groups.items()}}


# ------------------------------------------------------------ flash attention


def flash_inputs(torch, seed, b, sq, sk, hq, hkv, d, dtype, packed=False, broadcast=False):
    """q, k, v, g; with ``packed`` q, k and v are non-contiguous views cut
    from one (B, S, Hq + 2 Hkv, D) tensor, as a fused QKV projection gives;
    with ``broadcast`` k and v hold one KV head expanded to Hkv (stride 0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        qkv = torch.randn((b, sq, hq + 2 * hkv, d), generator=gen, device="cuda").to(dtype)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    elif broadcast:
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, sk, 1, d), generator=gen, device="cuda").to(dtype)
                .expand(b, sk, hkv, d) for _ in range(2))
    else:
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, g


def band_errors(torch, x, ref, seq_dim, split, band=WINDOW_BAND):
    """(rows < split, rows >= split): the largest over bands of ``band``
    rows along ``seq_dim`` of the band's max abs error over the RMS of
    ``ref`` in the band; 0 for a part with no rows."""
    d = (x.float() - ref.float()).movedim(seq_dim, 0)
    r = ref.float().movedim(seq_dim, 0)
    rel = torch.stack([dd.abs().max() / rr.square().mean().sqrt().clamp_min(1e-30)
                       for dd, rr in zip(d.split(band), r.split(band))]).tolist()
    return max(rel[:split // band], default=0.0), max(rel[split // band:], default=0.0)


def window_errors(torch, fwd, ref_fwd, grads, ref_grads, split, split_k=None):
    """The errors by name: out, dq, dk, dv by band against the reference's
    scale, lse absolutely, each as (rows < split, rows >= split); dk and dv
    split their key rows at ``split_k`` (default ``split``)."""
    split_k = split if split_k is None else split_k
    errs = {"out": band_errors(torch, fwd[0], ref_fwd[0], 1, split)}
    e_lse = (fwd[1] - ref_fwd[1].float()).abs()
    errs["lse"] = tuple(part.max().item() if part.numel() else 0.0
                        for part in (e_lse[..., :split], e_lse[..., split:]))
    for name, x, rx in zip(("dq", "dk", "dv"), grads, ref_grads):
        errs[name] = band_errors(torch, x, rx, 1, split if name == "dq" else split_k)
    return errs


def over_window_tol(errs, tol):
    """Names of the errors over ``tol`` (a BAND_TOL entry)."""
    return [n for n, e in errs.items()
            if max(e) > tol["lse_abs" if n == "lse" else "band_rel"]]


def show_window_errors(errs):
    return ", ".join(f"{n} {e[0]:.3e}/{e[1]:.3e}" for n, e in errs.items())


def flash_case(torch, label, dname, seed, b, sq, sk, hq, hkv, d, kw, errs, packed=False,
               broadcast=False):
    """One case of the flash kernels against their plain versions on the
    same inputs: out and lse within TOL, dq, dk, dv within GRAD_TOL of the
    gradient's largest entry; the backward of both gets the kernel's (out,
    lse), so each comparison isolates one kernel.  Raises on a
    disagreement, adds the largest errors to ``errs`` and returns the
    inputs and both sides' results."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_fwd,
                                                     flash_attention_fwd_ref)

    dtype = getattr(torch, dname)
    q, k, v, g = flash_inputs(torch, seed, b, sq, sk, hq, hkv, d, dtype, packed=packed,
                              broadcast=broadcast)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = flash_attention_fwd_ref(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, g, **kw)
    ref_grads = flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    tol = TOL[dname]
    e_out = (out.float() - ref_out.float()).abs().max().item()
    e_lse = (lse - ref_lse.float()).abs().max().item()
    ok = (out.dtype == dtype and out.shape == q.shape
          and torch.allclose(out.float(), ref_out.float(), atol=tol, rtol=tol)
          and torch.allclose(lse, ref_lse.float(), atol=tol, rtol=tol))
    rel = []
    for x, gr, rg in zip((q, k, v), grads, ref_grads):
        top = rg.float().abs().max().item()
        err = (gr.float() - rg.float()).abs().max().item()
        rel.append(err / max(1.0, top))
        ok = ok and gr.dtype == x.dtype and gr.shape == x.shape and \
            math.isfinite(err) and err <= GRAD_TOL[dname] * max(1.0, top)
        errs["bwd"] = max(errs["bwd"], err)
    errs["fwd"] = max(errs["fwd"], e_out, e_lse)
    print(f"flash_attention {label} {dname}: out max_abs_err {e_out:.3e}, lse "
          f"{e_lse:.3e} (tol {tol}); dq/dk/dv err / max(1, max|grad|) "
          f"{rel[0]:.2e} {rel[1]:.2e} {rel[2]:.2e} (tol {GRAD_TOL[dname]}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version "
                             f"on {label} {dname}")
    return (q, k, v, g), (out, lse), (ref_out, ref_lse), grads, ref_grads


def check_flash_attention(torch):
    """Forward (out, lse) and backward (dq, dk, dv) kernels against the
    plain versions on the same inputs (``flash_case``)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)

    cases = [  # (label, B, Sq, Sk, Hq, Hkv, D, mask)
        ("causal", 2, 128, 128, 4, 2, 64, dict(causal=True)),
        ("window", 2, 256, 256, 2, 2, 32, dict(causal=True, window=100)),
        ("chunk", 2, 128, 128, 4, 1, 64, dict(causal=True, chunk=32)),
        ("prefix", 2, 96, 96, 2, 2, 64, dict(causal=True, prefix_len=17)),
        ("non-causal Sk > Sq", 2, 64, 192, 2, 1, 128, dict(causal=False)),
        ("q_offset", 1, 100, 300, 24, 2, 128, dict(causal=True, q_offset=200)),
        ("S=1000 ragged", 1, 1000, 1000, 24, 2, 128, dict(causal=True)),
        ("S=4095 ragged 128-row tile", 1, 4095, 4095, 24, 2, 128, dict(causal=True)),
        ("D=64 rep 12", 1, 1024, 1024, 24, 2, 64, dict(causal=True)),
        ("packed qkv views", 2, 1000, 1000, 24, 2, 128, dict(causal=True)),
        ("D=256", 1, 100, 100, 2, 1, 256, dict(causal=True)),
        ("D=80 H2O-Danube heads", 1, 1000, 1000, 32, 8, 80, dict(causal=True)),
        ("D=96 GPT-MoE heads", 1, 1000, 1000, 8, 8, 96, dict(causal=True)),
        ("StarCoder2 S=4096", 1, 4096, 4096, 24, 2, 128, dict(causal=True)),
    ]
    # bf16 only, the training shapes of H2O-Danube (D = 80: the register-A
    # dK/dV form at DMAX 128) and Mixtral: S = 8192 past the 4096 window, so
    # a key tile sees only a band of q tiles
    windowed = [
        ("H2O-Danube S=8192 window 4096", 1, 8192, 8192, 32, 8, 80,
         dict(causal=True, window=4096)),
        ("Mixtral S=8192 window 4096", 1, 8192, 8192, 32, 8, 128,
         dict(causal=True, window=4096)),
    ]
    errs = {"fwd": 0.0, "bwd": 0.0}
    for dname in ("float32", "bfloat16"):
        for seed, (label, b, sq, sk, hq, hkv, d, kw) in enumerate(
                cases + (windowed if dname == "bfloat16" else [])):
            (q, k, v, g), fwd, ref_fwd, grads, ref_grads = flash_case(
                torch, label, dname, seed, b, sq, sk, hq, hkv, d, kw, errs,
                packed=label.startswith("packed"))
            if kw.get("window") and sq > kw["window"]:
                w = kw["window"]
                plants = [] if not label.startswith("H2O") else [
                    (f"window {p}", lambda p=p: planted(torch, q, k, v, g, fwd,
                                                        causal=True, window=p))
                    for p in (w - 64, w + 64)]
                band_check(torch, label, dname, fwd, ref_fwd, grads, ref_grads, w,
                           plants=plants, where="the window")
            del q, k, v, g, fwd, ref_fwd, grads, ref_grads
    # the backward has no atomics: the same inputs give the same bits
    q, k, v, g = flash_inputs(torch, 77, 1, 4096, 4096, 24, 2, 128, torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v)
    first = flash_attention_bwd(q, k, v, out, lse, g)
    second = flash_attention_bwd(q, k, v, out, lse, g)
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    print(f"flash_attention StarCoder2 S=4096 bfloat16 backward run twice: dq, dk, dv "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("flash_attention backward is not deterministic")
    return errs


def planted(torch, q, k, v, g, fwd, keys=None, **kw):
    """The plain version's (out, lse) and (dq, dk, dv) under the mask ``kw``,
    its backward from the kernel's ``fwd``; with ``keys`` it sees only the
    first ``keys`` keys, and its dk, dv get zero rows for the others."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)

    sk = k.shape[1]
    if keys is not None:
        k, v = k[:, :keys], v[:, :keys]
    ref_fwd = flash_attention_fwd_ref(q, k, v, **kw)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, *fwd, g, **kw)
    pad = [0, 0, 0, 0, 0, sk - k.shape[1]]
    return ref_fwd, (dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad))


def band_check(torch, label, dname, fwd, ref_fwd, grads, ref_grads, split, split_k=None,
               plants=(), where="the split"):
    """Hold a case to BAND_TOL of its dtype, by band, with rows before and
    from ``split`` (keys at ``split_k``) apart; each of ``plants``, (name, a
    function giving a planted plain version's forward and gradients), must
    go over the tolerance on every tensor."""
    tol = BAND_TOL[dname]
    errs = window_errors(torch, fwd, ref_fwd, grads, ref_grads, split, split_k)
    over = over_window_tol(errs, tol)
    print(f"flash_attention {label} {dname} against the reference's scale (rows before / "
          f"from {where}; band of {WINDOW_BAND} rows: max err / RMS, tol "
          f"{tol['band_rel']}; lse abs, tol {tol['lse_abs']}): "
          f"{show_window_errors(errs)} {'ok' if not over else 'FAIL ' + str(over)}")
    if over:
        raise AssertionError(f"flash_attention disagrees with its plain version on "
                             f"{label} {dname} at the reference's scale: {over}")
    for name, make in plants:
        p_fwd, p_grads = make()
        bad = window_errors(torch, fwd, p_fwd, grads, p_grads, split, split_k)
        caught = over_window_tol(bad, tol)
        print(f"flash_attention {label} {dname}: the plain version planted with {name}: "
              f"{show_window_errors(bad)}; over the tolerance: {caught}")
        if set(caught) != set(bad):
            raise AssertionError(f"the band check of {label} passes a plant of {name}: "
                                 f"only {caught} over the tolerance")
        del p_fwd, p_grads


def train_reduced_against_cpu(torch, arch="starcoder2", adam_eps=1e-8):
    """3 AdamW steps of a reduced config (StarCoder2 unless ``arch`` is
    given) in float32 on the CPU (plain versions) and on the card (kernels),
    from the same weights.  Returns the trained (CPU, card) models."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models import init_params
    from repro_torch.train import (OptConfig, TrainConfig, init_opt_state,
                                   make_train_step, synthetic_batch)

    cfg = get_arch(arch).reduced()
    tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=2, eps=adam_eps))
    cpu_model = init_params(cfg, torch.Generator().manual_seed(4), device="cpu",
                            dtype=torch.float32)
    card_model = copy.deepcopy(cpu_model).to("cuda")
    states = {dev: {"params": m, "opt": init_opt_state(m, tc.opt)}
              for dev, m in (("cpu", cpu_model), ("cuda", card_model))}
    step = make_train_step(cfg, tc)
    fwd0, bwd0 = flash_attention.launches, flash_attention_bwd.launches
    losses = {"cpu": [], "cuda": []}
    for i in range(3):
        host = synthetic_batch(cfg, i, 4, 64)
        for dev, state in states.items():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            states[dev], m = step(state, batch)
            losses[dev].append(float(m["loss"]))
    if flash_attention.launches == fwd0 or flash_attention_bwd.launches == bwd0:
        raise AssertionError("reduced training on the card launched no flash kernel")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cpu_p = dict(cpu_model.named_parameters())
    param_err, worst = max(((p.detach().cpu() - cpu_p[n].detach()).abs().max().item(), n)
                           for n, p in card_model.named_parameters())
    ok = loss_err <= TRAIN_TOL["loss_rel"] and param_err <= TRAIN_TOL["param_abs"]
    print(f"reference: reduced {cfg.name}, float32, 3 AdamW steps (eps {adam_eps}): losses "
          f"card {losses['cuda']} cpu {losses['cpu']}, max loss rel err {loss_err:.2e} "
          f"(tol {TRAIN_TOL['loss_rel']}), max weight abs err {param_err:.2e} in {worst} "
          f"(tol {TRAIN_TOL['param_abs']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("reduced training: card and CPU disagree")
    return cpu_model, card_model


# The decoder configs whose reduced versions run on card and CPU: sliding
# window (H2O-Danube), sliding window and MoE (Mixtral), chunked attention
# and MoE with a shared expert (Llama-4 Maverick).
DECODERS = ("h2o-danube", "mixtral", "llama4")
# Adam's eps in their card-against-CPU training, as in
# tests/test_torch_windowed.py: top-1 routing (Llama-4) renormalises the
# one weight to 1, so the router's gradient is zero but for rounding, which
# differs between card and CPU; eps = 1e-8 would turn that into moves of a
# sizeable share of lr.
DECODER_ADAM_EPS = 1e-6
# Mixtral-8x7B's training depth: 2 layers hold 3.165 B parameters, 51 GB
# with AdamW's fp32 master, m and v and bf16 gradients; 3 layers (74 GB of
# state) leave no room for the step's activations on an 80 GB card.
MIXTRAL_LAYERS = 2


def decoders_reduced_against_cpu(torch, archs=DECODERS):
    """Reduced configs (H2O-Danube, Mixtral and Llama-4 Maverick unless
    ``archs`` is given) with float32 weights on the CPU (plain versions) and
    on the card (kernels): ServeEngine token streams of prompts past the
    window of 32 (the ring caches wrap, the window and chunk masks cut keys)
    are equal, and 3 AdamW steps at S = 64 agree within TRAIN_TOL.  An
    encoder-decoder config's engines get their cache filled by
    ``encode_to_cache`` over the same float32 frames on both sides."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import encode_to_cache, init_params
    from repro_torch.serve import Request, ServeEngine

    for arch in archs:
        cfg = get_arch(arch).reduced()
        model = init_params(cfg, torch.Generator().manual_seed(6), device="cpu",
                            dtype=torch.float32)
        frames = torch.from_numpy((np.random.default_rng(8).standard_normal(
            (2, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32))
        streams = {}
        for dev in ("cpu", "cuda"):
            m = model if dev == "cpu" else copy.deepcopy(model).to("cuda")
            launches = decode_attention.launches
            eng = ServeEngine(cfg, m, max_batch=2, max_len=64, device=dev)
            if cfg.is_encdec:
                eng.cache = encode_to_cache(m, eng.cache, frames)
            streams[dev] = [r.out for r in serve(eng, Request, cfg.vocab_size, 3, 40, 8,
                                                 seed=7)]
        if decode_attention.launches == launches:
            raise AssertionError(f"reduced {cfg.name} served on the card without flash-decode")
        if streams["cpu"] != streams["cuda"]:
            raise AssertionError(f"reduced {cfg.name}: card {streams['cuda']} != "
                                 f"cpu {streams['cpu']}")
        print(f"reference: reduced {cfg.name} ({'/'.join(cfg.layer_pattern)}, window "
              f"{cfg.window}, {cfg.n_experts} experts, prefix {cfg.prefix_len}, "
              f"{cfg.enc_layers} encoder layers over {cfg.enc_seq} frames), float32 "
              f"weights, 3 requests of 40-token prompts through 2 slots of max_len 64"
              + (", engine cache filled by encode_to_cache" if cfg.is_encdec else "")
              + ": card token streams equal the CPU plain path's")
        train_reduced_against_cpu(torch, arch, adam_eps=DECODER_ADAM_EPS)


# PaliGemma-3B's attention in training: B=1, S=4096 (256 patches + 3840
# tokens), bidirectional within the 256-position prefix, MQA (8 query heads
# over 1 KV head) at D=256, bf16: the DMAX-256 Hopper kernels.
# Whisper-small's encoder (1500 frames)
# and cross-attention (448 tokens over 1500 frames), B=16, 12 heads, D=64,
# non-causal, 1500 keys = 23 whole 64-key tiles and a tail of 28: float32
# as the model runs them over float32 frames, and bf16.
PALIGEMMA_FLASH = ("PaliGemma prefix-LM", 1, 4096, 4096, 8, 1, 256,
                   dict(causal=True, prefix_len=256))
WHISPER_FLASH = [("Whisper encoder", 16, 1500, 1500, 12, 12, 64, dict(causal=False)),
                 ("Whisper cross-attention", 16, 448, 1500, 12, 12, 64, dict(causal=False))]


def check_vlm_encdec_flash(torch):
    """The flash kernels at PaliGemma's and Whisper's training shapes
    against their plain versions: absolutely (``flash_case``), and per band
    of 64 rows against the reference's scale (``band_check``), PaliGemma's
    rows before and from the prefix's end, Whisper's before and in the
    ragged last tile (queries and keys apart).  Plain versions planted with
    a prefix of 256 - 64 and 256 + 64, and with 1500 - 64 keys (float32),
    must go over the band tolerance on every tensor."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    cases = [(PALIGEMMA_FLASH, "bfloat16")] + [
        (c, dname) for c in WHISPER_FLASH for dname in ("float32", "bfloat16")]
    for seed, ((label, b, sq, sk, hq, hkv, d, kw), dname) in enumerate(cases):
        (q, k, v, g), fwd, ref_fwd, grads, ref_grads = flash_case(
            torch, f"{label} B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d}", dname,
            300 + seed, b, sq, sk, hq, hkv, d, kw, errs)
        prefix = kw.get("prefix_len", 0)
        if prefix:
            plants = [(f"prefix {p}", lambda p=p: planted(torch, q, k, v, g, fwd, causal=True,
                                                          prefix_len=p))
                      for p in (prefix - 64, prefix + 64)]
            band_check(torch, label, dname, fwd, ref_fwd, grads, ref_grads, prefix,
                       plants=plants, where="the prefix's end")
        else:
            plants = [] if dname != "float32" else [
                (f"key length {sk - 64} (its dk, dv rows of the other 64 keys are zero, so "
                 f"their band reads err / 1e-30)",
                 lambda: planted(torch, q, k, v, g, fwd, keys=sk - 64, causal=False))]
            band_check(torch, label, dname, fwd, ref_fwd, grads, ref_grads,
                       sq // WINDOW_BAND * WINDOW_BAND, sk // WINDOW_BAND * WINDOW_BAND,
                       plants=plants, where="the ragged last tile")
        del q, k, v, g, fwd, ref_fwd, grads, ref_grads
        torch.cuda.empty_cache()
    return errs


# Edge cases of the bf16 kernels at DMAX 256 (label, dtype, B, Sq, Sk, Hq,
# Hkv, D, mask, packed): a ragged last tile with 2 KV heads, Sq != Sk with a
# query offset, a chunk that cuts tiles, q/k/v cut from one packed QKV
# tensor, Sk > Sq without the causal mask, D=192 (the last of the four
# 64-column boxes reads zeros past D); float32 at D=256 takes the 3xTF32
# kernels' DMAX-256 tiles.
D256_FLASH = [
    ("D=256 S=4095 GQA 8/2", "bfloat16", 1, 4095, 4095, 8, 2, 256, dict(causal=True), False),
    ("D=256 Sq=300 Sk=1000 q_offset 700", "bfloat16", 1, 300, 1000, 8, 2, 256,
     dict(causal=True, q_offset=700), False),
    ("D=256 chunk 200", "bfloat16", 1, 1000, 1000, 4, 2, 256, dict(causal=True, chunk=200), False),
    ("D=256 packed qkv views", "bfloat16", 2, 1000, 1000, 8, 2, 256, dict(causal=True), True),
    ("D=256 non-causal Sk > Sq", "bfloat16", 2, 64, 192, 2, 1, 256, dict(causal=False), False),
    ("D=192", "bfloat16", 1, 1000, 1000, 8, 1, 192, dict(causal=True), False),
    ("D=256 on the 3xTF32 kernels", "float32", 1, 300, 300, 4, 2, 256, dict(causal=True), False),
]
# The kernels of each route: bf16 takes TMA and wgmma, float32 the 3xTF32
# mma.sync kernels (csrc/flash_attention.cu).
FLASH_ROUTES = {
    "bfloat16": {"flash_fwd_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
                 "flash_bwd_dq_wgmma_kernel"},
    "float32": {"flash_fwd_tf32x3_kernel", "flash_bwd_dkdv_tf32x3_kernel",
                "flash_bwd_dq_tf32x3_kernel"},
}


def flash_kernels_run(torch, fn, want, tries=5):
    """The flash-attention kernels ``fn`` launches, as (name, DMAX) pairs
    read from torch.profiler's kernel names (demangled or not): the union
    over up to ``tries`` profiles of two calls each, after a warm-up call,
    stopping once every pair of ``want`` was seen (an isolated profile can
    miss launches, PERF.md § 7)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ran = set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        ran |= {m.groups() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                for m in [re.search(
                    r"(flash_(?:fwd|bwd_dkdv|bwd_dq)_(?:wgmma|tf32x3)_kernel)(?:<|ILi)(\d+)",
                    e.name)] if m}
        if want <= ran:
            break
    return ran


def check_route(torch, label, dname, q, k, v, g, kw):
    """Raise unless a forward and a backward on (q, k, v, g) launch the
    three kernels of ``dname``'s route at the DMAX of q's head dim, and no
    other flash kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.flash_attention import dmax

    want = {(n, str(dmax(q.shape[-1]))) for n in FLASH_ROUTES[dname]}
    ran = flash_kernels_run(torch, lambda: flash_attention_bwd(
        q, k, v, *flash_attention_fwd(q, k, v, **kw), g, **kw), want)
    ok = ran == want
    print(f"flash_attention {label} {dname}: kernels run "
          f"{sorted(f'{n}<{dm}>' for n, dm in ran)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention {label} {dname} took the wrong kernels: {ran}")


def check_repeat(torch, label, dname, q, k, v, g, kw):
    """The forward and the backward each give the same bits twice: no
    atomics in either direction."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    fwd = [flash_attention_fwd(q, k, v, **kw) for _ in range(2)]
    bwd = [flash_attention_bwd(q, k, v, *fwd[0], g, **kw) for _ in range(2)]
    same = {"forward": all(torch.equal(x, y) for x, y in zip(*fwd)),
            "backward": all(torch.equal(x, y) for x, y in zip(*bwd))}
    print(f"flash_attention {label} {dname} run twice: "
          + ", ".join(f"{n} {'bit-identical' if ok else 'DIFFER'}" for n, ok in same.items()))
    if not all(same.values()):
        raise AssertionError(f"flash_attention {label} {dname} is not deterministic: {same}")


def check_d256_flash(torch):
    """The bf16 kernels at D > 128 (DMAX 256) against their plain versions
    on ``D256_FLASH``, absolutely (``flash_case``) and per band of 64 rows
    (``band_check``, rows before and in the ragged last tile); each bf16
    case launches only the three wgmma kernels, the float32 case only the
    3xTF32 ones; the forward and the backward at PaliGemma's training shape
    are bit-identical when run twice.  Returns the largest errors."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    for seed, (label, dname, b, sq, sk, hq, hkv, d, kw, packed) in enumerate(D256_FLASH):
        (q, k, v, g), fwd, ref_fwd, grads, ref_grads = flash_case(
            torch, label, dname, 700 + seed, b, sq, sk, hq, hkv, d, kw, errs, packed=packed)
        band_check(torch, label, dname, fwd, ref_fwd, grads, ref_grads,
                   sq // WINDOW_BAND * WINDOW_BAND, sk // WINDOW_BAND * WINDOW_BAND,
                   where="the ragged last tile")
        check_route(torch, label, dname, q, k, v, g, kw)
        del q, k, v, g, fwd, ref_fwd, grads, ref_grads
        torch.cuda.empty_cache()
    label, b, sq, sk, hq, hkv, d, kw = PALIGEMMA_FLASH
    q, k, v, g = flash_inputs(torch, 78, b, sq, sk, hq, hkv, d, torch.bfloat16)
    check_repeat(torch, f"{label} B={b} S={sq} Hq={hq} Hkv={hkv} D={d}", "bfloat16",
                 q, k, v, g, kw)
    del q, k, v, g
    torch.cuda.empty_cache()
    return errs


# Edge cases of the float32 (3xTF32) kernels beside Whisper's shapes, each
# held to its plain version (label, B, Sq, Sk, Hq, Hkv, D, mask, packed,
# broadcast): a window, a chunk and a prefix that cut tiles, Sq != Sk with a
# query offset, D=80 (two 64-column blocks, the second 16 wide), GQA 8/2
# with a ragged last tile, q/k/v cut from one packed QKV tensor, and a KV
# head broadcast (stride 0) over two.
F32_FLASH = [
    ("window 300", 1, 1000, 1000, 8, 2, 64, dict(causal=True, window=300), False, False),
    ("chunk 200", 1, 1000, 1000, 4, 2, 64, dict(causal=True, chunk=200), False, False),
    ("prefix 256", 2, 1000, 1000, 4, 1, 64, dict(causal=True, prefix_len=256), False, False),
    ("Sq=300 Sk=1000 q_offset 700", 1, 300, 1000, 8, 2, 64, dict(causal=True, q_offset=700),
     False, False),
    ("D=80", 1, 1000, 1000, 8, 2, 80, dict(causal=True), False, False),
    ("GQA 8/2 S=1500", 2, 1500, 1500, 8, 2, 64, dict(causal=False), False, False),
    ("packed qkv views", 2, 1000, 1000, 8, 2, 64, dict(causal=True), True, False),
    ("broadcast KV head", 2, 1000, 1000, 8, 2, 64, dict(causal=True), False, True),
]


def check_f32_flash(torch):
    """The float32 (3xTF32) kernels: at both of Whisper's shapes they launch
    only the three 3xTF32 kernels, and at its encoder shape the forward and
    the backward are bit-identical when run twice; each case of
    ``F32_FLASH`` agrees with its plain version absolutely (``flash_case``)
    and per band of 64 rows (``band_check``) and takes the same route.
    Returns the largest errors."""
    for seed, (label, b, sq, sk, hq, hkv, d, kw) in enumerate(WHISPER_FLASH):
        q, k, v, g = flash_inputs(torch, 400 + seed, b, sq, sk, hq, hkv, d, torch.float32)
        name = f"{label} B={b} Sq={sq} Sk={sk} Hq={hq} D={d}"
        check_route(torch, name, "float32", q, k, v, g, kw)
        if seed == 0:
            check_repeat(torch, name, "float32", q, k, v, g, kw)
        del q, k, v, g
        torch.cuda.empty_cache()
    errs = {"fwd": 0.0, "bwd": 0.0}
    for seed, (label, b, sq, sk, hq, hkv, d, kw, packed, broadcast) in enumerate(F32_FLASH):
        (q, k, v, g), fwd, ref_fwd, grads, ref_grads = flash_case(
            torch, label, "float32", 800 + seed, b, sq, sk, hq, hkv, d, kw, errs,
            packed=packed, broadcast=broadcast)
        band_check(torch, label, "float32", fwd, ref_fwd, grads, ref_grads,
                   sq // WINDOW_BAND * WINDOW_BAND, sk // WINDOW_BAND * WINDOW_BAND,
                   where="the ragged last tile")
        check_route(torch, label, "float32", q, k, v, g, kw)
        del q, k, v, g, fwd, ref_fwd, grads, ref_grads
        torch.cuda.empty_cache()
    return errs


def decode_rel(out, ref):
    """Flash-decode's max abs error over the RMS of the plain version's output."""
    return ((out.float() - ref.float()).abs().max() / ref.float().square().mean().sqrt()).item()


def decode_judge(torch, label, out, ref, qdt):
    """Hold a flash-decode output to its plain version's: within TOL's bf16
    tolerance absolutely and DECODE_REL_TOL of its RMS.  Returns the max abs
    error; raises on a disagreement."""
    err = (out.float() - ref.float()).abs().max().item()
    r = decode_rel(out, ref)
    tol = TOL["bfloat16"]
    ok = out.dtype == qdt and out.shape == ref.shape and r <= DECODE_REL_TOL and \
        torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    print(f"decode_attention {label}: max_abs_err {err:.3e} (tol {tol}), over the "
          f"reference's RMS {r:.3e} (tol {DECODE_REL_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention disagrees with its plain version on {label}")
    return err


def check_vlm_encdec_decode(torch):
    """Flash-decode at PaliGemma's serving shape (slot form, MQA 8 over 1
    KV head, D=256, bf16, a cache filled below position 64 and a wrapped
    one) and Whisper's cross-attention (lengths form, L=1500 with every key
    live, Hq=Hkv=12, D=64, a bf16 q over a float32 cache), against the plain
    versions: within TOL absolutely and within DECODE_REL_TOL of the plain
    version's RMS; a plain version planted with 1500 - 64 keys must go over
    the latter."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_cache,
                                                      decode_attention_cache_ref,
                                                      decode_attention_ref)

    bf, f32 = torch.bfloat16, torch.float32
    errs = []
    for seed, (what, lo, hi) in enumerate([("filled below position 64", 0, 64),
                                           ("wrapped", 1024, 4000)]):
        q, k, v, sp, qp = slot_inputs(torch, 400 + seed, 8, 8, 1, 256, 1024, bf, bf, lo, hi)
        out = decode_attention_cache(q, k, v, sp, qp)
        ref = decode_attention_cache_ref(q, k, v, sp, qp)
        torch.cuda.synchronize()
        errs.append(decode_judge(
            torch, f"PaliGemma slots B=8 Hq=8 Hkv=1 D=256 W=1024 bf16, {what}", out, ref, bf))
    q, k, v, lengths = attention_inputs(torch, 410, 8, 12, 12, 64, 1500, bf, f32)
    lengths.fill_(1500)
    out = decode_attention(q, k, v, lengths)
    ref = decode_attention_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    errs.append(decode_judge(torch, "Whisper cross-attention B=8 L=1500 Hq=Hkv=12 D=64, bf16 "
                             "q over a float32 cache, every key live", out, ref, bf))
    bad = decode_rel(out, decode_attention_ref(q, k, v, lengths - 64))
    print(f"decode_attention Whisper cross-attention: the plain version planted with key "
          f"length 1500 - 64: over its RMS {bad:.3e} (tol {DECODE_REL_TOL})")
    if bad <= DECODE_REL_TOL:
        raise AssertionError("the decode check passes a plain version that drops 64 keys")
    return max(errs)


# RecurrentGemma-2B's local attention in training: B=1, S=4096 past its 2048
# window, MQA (10 query heads over 1 KV head) at D=256, bf16: the DMAX-256
# Hopper kernels.  Its serving shape: 8 lanes over a 2048-slot ring,
# positions past 2048 so that the ring has wrapped.
RECURRENTGEMMA_FLASH = ("RecurrentGemma local attention", 1, 4096, 4096, 10, 1, 256,
                        dict(causal=True, window=2048))
RECURRENTGEMMA_DECODE = dict(b=8, hq=10, hkv=1, d=256, w=2048)


def check_recurrentgemma_kernels(torch):
    """The flash kernels at RecurrentGemma's training shape against their
    plain versions, absolutely (``flash_case``) and per band of 64 rows
    against the reference's scale (``band_check``, rows before and from the
    window), with plain versions planted with windows of 2048 - 64 and
    2048 + 64 caught; flash-decode's slot form at its serving shape on a
    wrapped ring, with a plain version planted with a window of 2048 - 64
    caught.  Returns the largest errors."""
    from repro_torch.kernels.decode_attention import (decode_attention_cache,
                                                      decode_attention_cache_ref)

    errs = {"fwd": 0.0, "bwd": 0.0}
    label, b, sq, sk, hq, hkv, d, kw = RECURRENTGEMMA_FLASH
    (q, k, v, g), fwd, ref_fwd, grads, ref_grads = flash_case(
        torch, f"{label} B={b} S={sq} Hq={hq} Hkv={hkv} D={d} window {kw['window']}",
        "bfloat16", 600, b, sq, sk, hq, hkv, d, kw, errs)
    w = kw["window"]
    plants = [(f"window {p}", lambda p=p: planted(torch, q, k, v, g, fwd, causal=True, window=p))
              for p in (w - 64, w + 64)]
    band_check(torch, label, "bfloat16", fwd, ref_fwd, grads, ref_grads, w, plants=plants,
               where="the window")
    del q, k, v, g, fwd, ref_fwd, grads, ref_grads
    torch.cuda.empty_cache()

    bf = torch.bfloat16
    dc = RECURRENTGEMMA_DECODE
    q, k, v, sp, qp = slot_inputs(torch, 610, dc["b"], dc["hq"], dc["hkv"], dc["d"], dc["w"],
                                  bf, bf, dc["w"], 4 * dc["w"])
    out = decode_attention_cache(q, k, v, sp, qp, window=dc["w"])
    ref = decode_attention_cache_ref(q, k, v, sp, qp, window=dc["w"])
    torch.cuda.synchronize()
    errs["decode"] = decode_judge(
        torch, f"RecurrentGemma slots B={dc['b']} Hq={dc['hq']} Hkv={dc['hkv']} D={dc['d']} "
        f"W={dc['w']} window {dc['w']} bf16, wrapped (positions {int(qp.min())}-"
        f"{int(qp.max())})", out, ref, bf)
    bad = decode_rel(out, decode_attention_cache_ref(q, k, v, sp, qp, window=dc["w"] - 64))
    print(f"decode_attention RecurrentGemma slots: the plain version planted with window "
          f"{dc['w'] - 64}: over its RMS {bad:.3e} (tol {DECODE_REL_TOL})")
    if bad <= DECODE_REL_TOL:
        raise AssertionError("the decode check passes a plain version with a window 64 short")
    return errs


def lockstep_tokens(torch, model, toks):
    """Greedy next tokens of ``decode_step`` fed the (lanes, steps) host
    tokens ``toks``, every lane at the same position, from a float32 cache
    of ``steps`` slots (a windowed layer's ring is cut to its window)."""
    from repro_torch.models import decode_step, init_cache

    lanes, steps = toks.shape
    cache = init_cache(model, lanes, steps, dtype=torch.float32)
    got = [decode_step(model, cache, toks[:, i:i + 1], np.full(lanes, i))[0].cpu()
           for i in range(steps)]
    return torch.stack(got, 1).tolist()


# Adam's eps in RecurrentGemma's card-against-CPU training.  Its float32
# gradients agree to ~1e-5 of each tensor's largest entry (the embedding's
# differ by up to ~2e-6 absolutely), but entries of ~1e-9 (an MLP gate) or
# ~1e-6 (embedding rows) are then rounding noise, and at eps 1e-8 or 1e-6
# Adam turns such an entry into a move that differs by ~lr / 10, over
# TRAIN_TOL's 1e-4.  At eps 1e-3 three steps move an entry by at most
# 3 lr 2e-6 / eps = 1.8e-5 more on one side.  The gradients themselves are
# held to REDUCED_GRAD_TOL of each tensor's largest entry first.
RECURRENT_ADAM_EPS = 1e-3
REDUCED_GRAD_TOL = 5e-5


def recurrentgemma_reduced_against_cpu(torch):
    """Reduced RecurrentGemma (rglru, rglru, swa; window 32) in float32 on
    the CPU (plain versions) and on the card (kernels): every parameter's
    gradient of one batch agrees within REDUCED_GRAD_TOL of its largest
    entry, 3 AdamW steps agree (``train_reduced_against_cpu``), then 48
    lockstep decode steps of 3 lanes, past the window and around the 32-slot
    ring, give the same tokens on both."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import forward, init_params, lm_loss
    from repro_torch.train import synthetic_batch

    cfg = get_arch("recurrentgemma").reduced()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(4), device="cpu",
                            dtype=torch.float32)
    host = synthetic_batch(cfg, 0, 4, 64)
    grads = {}
    for dev, m in (("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        names, params = zip(*m.named_parameters())
        loss = lm_loss(m, forward(m, batch), batch["labels"])
        grads[dev] = dict(zip(names, (g.cpu() for g in torch.autograd.grad(loss, params))))
    rel, worst = max(((grads["cuda"][n] - g).abs().max().item()
                      / g.abs().max().clamp_min(1e-30).item(), n)
                     for n, g in grads["cpu"].items())
    print(f"reference: reduced {cfg.name}, float32 gradients of one batch, card against "
          f"CPU: largest err / max|grad| {rel:.2e} in {worst} (tol {REDUCED_GRAD_TOL}) "
          f"{'ok' if rel <= REDUCED_GRAD_TOL else 'FAIL'}")
    if rel > REDUCED_GRAD_TOL:
        raise AssertionError("reduced RecurrentGemma gradients: card and CPU disagree")
    models = train_reduced_against_cpu(torch, "recurrentgemma", adam_eps=RECURRENT_ADAM_EPS)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (3, 48))
    launches = decode_attention.launches
    out = {dev: lockstep_tokens(torch, m, toks) for dev, m in zip(("cpu", "cuda"), models)}
    if decode_attention.launches == launches:
        raise AssertionError("reduced RecurrentGemma decoded on the card without flash-decode")
    if out["cpu"] != out["cuda"]:
        raise AssertionError(f"reduced RecurrentGemma lockstep decode: card {out['cuda']} != "
                             f"cpu {out['cpu']}")
    print(f"reference: reduced {cfg.name}, float32, 48 lockstep decode steps of 3 lanes past "
          f"the window of {cfg.window}: card tokens equal the CPU's")


def attention_layers(cfg):
    """The number of decoder layers with self-attention: a Mamba-2 or
    RG-LRU layer has none."""
    return sum(cfg.pattern_at(i) in ("attn", "swa", "chunked")
               for i in range(cfg.num_layers))


def attention_flops(cfg, batch, seq):
    """Model FLOPs of attention scores and values in one training step:
    forward 4 * pairs * D per head, backward twice that, where the pairs are
    the (query, key) pairs each layer's mask keeps: causal, within the
    window (``swa``) or within the chunk (``chunked``), all pairs of the
    prefix both ways; a layer kind without attention keeps none."""
    p = cfg.prefix_len
    pairs = {"attn": seq * (seq + 1) // 2 + p * (p - 1) // 2,
             "swa": sum(min(q + 1, cfg.window) for q in range(seq)) if cfg.window else 0,
             "chunked": sum(q % cfg.window + 1 for q in range(seq)) if cfg.window else 0}
    total = sum(pairs.get(cfg.pattern_at(i), 0) for i in range(cfg.num_layers))
    return 3 * 4 * total * cfg.head_dim * cfg.n_heads * batch


def train_flops(cfg, n_active, batch, seq):
    """(bf16 FLOPs, float32 FLOPs) of one training step's model work: 6 x
    parameters x tokens plus attention.  An encoder-decoder config's encoder
    runs over ``enc_seq`` frames, and its float32 frames keep the encoder,
    the cross K/V projections and the cross-attention in float32 (bf16
    weights promoted), which run at FP32_FLOPS, not on the tensor cores."""
    if not cfg.is_encdec:
        return 6 * n_active * batch * seq + attention_flops(cfg, batch, seq), 0
    d, f, se = cfg.d_model, cfg.d_ff, cfg.enc_seq
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    enc_layer = 4 * d * d + mats * d * f
    dec_layer = 4 * d * d + 2 * d * d + mats * d * f        # self, cross q/o, MLP
    head = cfg.vocab_size * d
    hd_h = cfg.head_dim * cfg.n_heads
    f32 = (6 * enc_layer * cfg.enc_layers * batch * se
           + 6 * 2 * d * d * cfg.num_layers * batch * se      # cross K/V projections
           + 3 * 4 * hd_h * batch * (cfg.enc_layers * se * se + cfg.num_layers * seq * se))
    bf16 = 6 * (dec_layer * cfg.num_layers + head) * batch * seq + attention_flops(cfg, batch, seq)
    return bf16, f32


def flash_calls(cfg):
    """(forward, backward) flash-attention launches of one training step
    with remat: each decoder layer's self-attention, and cross-attention
    where it has one, runs forward twice (the remat recompute) and backward
    once; each encoder layer, which ``encode`` does not recompute, once
    each.  Recurrent layers launch none."""
    calls = attention_layers(cfg) * (2 if cfg.is_encdec else 1)
    return 2 * calls + cfg.enc_layers, calls + cfg.enc_layers


MOE_RANGES = ("moe.route", "moe.scatter", "moe.experts", "moe.combine")
# autograd nodes that only the MoE layers' backward runs: the router's
# softmax and top-k, the scatter's, the combine's gather and the experts'
MOE_BACKWARD = ("SoftmaxBackward0", "SortBackward0", "IndexPutBackward0",
                "IndexSelectBackward0", "BmmBackward0")


def range_device_ms(prof, names):
    """Device ms of each profiler range or autograd node in ``names``, from
    a profile that traced the CPU side too."""
    avg = {e.key: e for e in prof.key_averages()}
    return {n: (getattr(avg[n], "device_time_total", 0.0) / 1e3 if n in avg else 0.0)
            for n in names}


def moe_drops(torch, model, batch, moe_ctx=None):
    """(dropped, routed) expert assignments of a no-grad forward of
    ``batch``, from the MoE layers' telemetry counters (this process's
    rank's under a mesh)."""
    from repro_torch import obs
    from repro_torch.models import forward

    obs.enable()
    obs.reset()
    with torch.no_grad():
        forward(model, batch, moe_ctx=moe_ctx)
    counters = obs.summary()["counters"]
    obs.disable()
    obs.reset()
    return counters["moe.dropped_assignments"], counters["moe.assignments"]


def train_full(torch, cfg=None, batch=1, seq=4096, timed=3):
    """Training main path: a full-width config (StarCoder2-3B unless ``cfg``
    is given), bf16, remat, AdamW: one warm-up step, ``timed`` timed steps
    with the launch counts checked (``flash_calls``), one profiled step.
    MFU counts the active parameters (an MoE token runs top-k of its
    experts) and, for an encoder-decoder config, the encoder's work over
    its frames (``train_flops``).  ``seq`` counts a VLM's patches."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.train import (TrainConfig, init_train_state, make_train_step,
                                   synthetic_batch)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or get_arch("starcoder2")
    tc = TrainConfig(remat=True)
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, 0, device="cuda", dtype=torch.bfloat16)
    model = state["params"]
    torch.cuda.synchronize()
    # N counts the model's tensors (a tied embedding once); the config's
    # analytic param_count() is printed beside it (for RG-LRU layers it
    # leaves out w_r, w_i and the conv, as repro's formula does)
    n_params = sum(p.numel() for p in model.parameters())
    n_active = n_params - (cfg.param_count() - cfg.active_param_count())
    print(f"train: {cfg.name}, {depth(cfg)}, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B parameters by numel (param_count() "
          f"{cfg.param_count() / 1e9:.4f} B; {n_active / 1e9:.4f} B active a token), "
          f"AdamW state made in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    step = make_train_step(cfg, tc)

    def batch_at(i):
        host = synthetic_batch(cfg, i, batch, seq)
        return {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}

    if cfg.n_experts:
        # the synthetic tokens are Zipf(1.3) unigrams: equal tokens take the
        # same experts at layer 0, so the drops are also read on tokens drawn
        # uniformly from the vocabulary, with the same weights
        first = batch_at(0)
        uniform = {"tokens": torch.randint(
            0, cfg.vocab_size, first["tokens"].shape, dtype=first["tokens"].dtype,
            device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))}
        top = torch.bincount(first["tokens"].flatten()).sort(descending=True)
        drops = {"before": moe_drops(torch, model, first),
                 "uniform": moe_drops(torch, model, uniform)}
        print(f"train: {cfg.name}: the warm-up batch's most frequent token ids "
              + ", ".join(f"{i} {100 * n / first['tokens'].numel():.1f}%" for n, i in
                          zip(top.values[:4].tolist(), top.indices[:4].tolist()))
              + " of its positions")
    state, m = step(state, batch_at(0))                      # warm-up
    torch.cuda.synchronize()
    print(f"train: {cfg.name}: warm-up step loss {float(m['loss']):.4f} grad_norm "
          f"{float(m['grad_norm']):.4f}")
    last, first = model.layers[-1], model.layers[0]
    first_w = first.attn["wq"] if first.attn is not None else first.rglru["w_x"]
    watch = {"embed": model.embed, f"{first.kind}0": first_w,
             f"w_down{len(model.layers) - 1}":
                 last.moe.w_down if last.moe is not None else last.mlp["w_down"]}
    if model.enc is not None:
        watch.update(enc_wq0=model.enc.layers[0].attn["wq"],
                     xattn_wk0=model.layers[0].xattn["wk"])
    before = {n: p.detach()[:8].clone() for n, p in watch.items()}
    batches = [batch_at(1 + i) for i in range(timed)]
    torch.cuda.synchronize()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    times, metrics = [], []
    for b in batches:
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        metrics.append({k: float(v) for k, v in m.items()})
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    want_fwd, want_bwd = flash_calls(cfg)
    if fwd != want_fwd * timed or bwd != want_bwd * timed:
        raise AssertionError(f"flash_attention launched {fwd} forward and {bwd} backward "
                             f"in {timed} steps of {cfg.num_layers} layers with remat; want "
                             f"{want_fwd * timed} and {want_bwd * timed}")
    if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"]) for x in metrics):
        raise AssertionError(f"non-finite loss or grad norm: {metrics}")
    changed = {n: not torch.equal(before[n], p.detach()[:8]) for n, p in watch.items()}
    if not all(changed.values()):
        raise AssertionError(f"weights did not change: {changed}")
    tokens = batch * seq
    step_s = statistics.median(times)
    bf16_flops, f32_flops = train_flops(cfg, n_active, batch, seq)
    model_flops = bf16_flops + f32_flops
    flop_ms = (bf16_flops / BF16_FLOPS + f32_flops / FP32_FLOPS) * 1e3
    # AdamW reads and writes fp32 master, m and v and reads the grads, once
    opt_bytes = n_params * (3 * 4 * 2 + 2 + 2)
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    mfu = model_flops / (step_s * BF16_FLOPS)
    print(f"train: {cfg.name}: {timed} timed steps of B={batch} S={seq}: "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms; median "
          f"{step_s * 1e3:.1f} ms per step, {tokens / step_s:.0f} tok/s, MFU "
          f"{100 * mfu:.2f}% ({model_flops / 1e12:.2f} TFLOP per step at 989 TFLOP/s"
          + (f", {f32_flops / 1e12:.2f} of them float32 at 67 TFLOP/s" if f32_flops else "")
          + f"); bound {flop_ms + opt_ms:.1f} ms per step ({flop_ms:.1f} ms of FLOPs + "
          f"{opt_ms:.1f} ms of optimizer bytes); peak memory {peak / 1e9:.2f} GB"
          + (f"; {batch * cfg.enc_seq / step_s:.0f} encoder frames/s" if cfg.is_encdec
             else ""))
    print(f"train: {cfg.name}: losses " + ", ".join(f"{x['loss']:.4f}" for x in metrics)
          + "; grad norms " + ", ".join(f"{x['grad_norm']:.4f}" for x in metrics)
          + f"; weights changed {changed}")
    print(f"train: {cfg.name}: flash_attention launches {fwd} forward = {want_fwd} x {timed} "
          f"steps, {bwd} backward = {want_bwd} x {timed} ({attention_layers(cfg)} of "
          f"{cfg.num_layers} decoder layers attend"
          + (f" with cross-attention, {cfg.enc_layers} encoder layers)" if cfg.is_encdec
             else ")"))
    if cfg.n_experts:
        drops["after"] = moe_drops(torch, model, batches[-1])
        print(f"train: {cfg.name}: expert assignments dropped at capacity factor "
              f"{cfg.capacity_factor} ({cfg.n_experts} experts, top-{cfg.top_k}), by "
              f"no-grad forwards: {drops['before'][0]} of {drops['before'][1]} in the "
              f"warm-up batch with the initial weights, {drops['after'][0]} of "
              f"{drops['after'][1]} in the last timed batch after {1 + timed} steps; "
              f"{drops['uniform'][0]} of {drops['uniform'][1]} with the initial weights "
              f"on uniformly drawn tokens")

    # an MoE or RG-LRU step also traces the CPU side, for the device time of
    # its ranges
    rglru = "rglru" in cfg.layer_pattern
    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cfg.n_experts or rglru else [])
    with profile(activities=acts) as prof:
        t1 = time.perf_counter()
        state, m = step(state, batch_at(1 + timed))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    busy = summarize_profile(
        torch, prof, wall_ms, 1, f"{cfg.name}: 1 training step of B={batch} S={seq}",
        {"flash fwd": "flash_fwd", "flash dK/dV": "flash_bwd_dkdv",
         "flash dQ": "flash_bwd_dq", "flash delta": "flash_bwd_delta",
         "flash reduce": "flash_bwd_reduce", "cuBLAS GEMM": "nvjet", "other GEMM": "gemm"})
    if busy:
        grp = busy["groups"]
        flash_ms = sum(t for g, t in grp.items() if g.startswith("flash"))
        gemm_ms = grp["cuBLAS GEMM"] + grp["other GEMM"]
        print(f"profile: {cfg.name}: flash-attention kernels {100 * flash_ms / busy['busy_ms']:.1f}% "
              f"and GEMMs {100 * gemm_ms / busy['busy_ms']:.1f}% of the step's busy time")
        if rglru:
            # the RG-LRU scan's forward (twice with remat) and backward run
            # under the "rglru.scan" range
            scan_ms = range_device_ms(prof, ["rglru.scan"])["rglru.scan"]
            rest_ms = busy["busy_ms"] - flash_ms - gemm_ms - scan_ms
            shares = {"flash": flash_ms, "rglru.scan": scan_ms, "gemm": gemm_ms,
                      "rest": rest_ms}
            print(f"profile: {cfg.name}: device ms in the step: " + ", ".join(
                f"{k} {v:.1f} ({100 * v / busy['busy_ms']:.1f}%)" for k, v in shares.items())
                + f" of {busy['busy_ms']:.1f} busy ms (rest: elementwise, norms, optimizer, "
                  f"copies)")
    if cfg.n_experts and busy:
        ms = range_device_ms(prof, MOE_RANGES + MOE_BACKWARD)
        share = {
            "route": ms["moe.route"] + ms["SoftmaxBackward0"] + ms["SortBackward0"],
            "scatter": ms["moe.scatter"] + ms["IndexPutBackward0"],
            "combine": ms["moe.combine"] + ms["IndexSelectBackward0"],
            "experts": ms["moe.experts"] + ms["BmmBackward0"]}
        print(f"profile: {cfg.name}: MoE device ms in the step (forward ranges twice "
              f"with remat; backward by autograd node): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + "; share of the busy time: "
              + ", ".join(f"{k} {100 * v / busy['busy_ms']:.2f}%" for k, v in share.items()))
    del state, model, step, batches, watch, before, prof
    gc.collect()
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd, "ms_per_step": step_s * 1e3,
            "tok_per_s": tokens / step_s, "mfu": mfu, "peak_gb": peak / 1e9}


def kernel_ms_by_group(torch, fn, calls, groups=None, once_per_call=False):
    """Device ms per call of the kernels whose names hold each substring of
    ``groups`` (label -> substring), or without ``groups`` of each kernel
    function (``..._kernel``) in the order of first launch, from
    torch.profiler over ``calls`` calls of ``fn``.  With ``once_per_call``
    (each call launches each group's kernel once) a group's time is the
    mean of the launches the profiler recorded: it can miss whole calls of
    kernels that run for milliseconds, and says so."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(groups, 0.0) if groups else {}
    seen = dict.fromkeys(groups, 0) if groups else {}
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        ms = (e.time_range.end - e.time_range.start) / 1e3 / calls
        if groups:
            for label, sub in groups.items():
                if sub in e.name:
                    out[label] += ms
                    seen[label] += 1
        else:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + ms
    if once_per_call:
        for label, n in seen.items():
            if n:
                out[label] *= calls / n
            if n not in (0, calls):
                print(f"profile: {n} of {calls} launches of {groups[label]} recorded; "
                      f"timed by their mean")
    return out


def kernel_names(torch, fn, calls=3):
    """The names of the CUDA kernels ``fn`` launches, from torch.profiler
    over ``calls`` calls after a warm-up call (an isolated profile of one
    call can miss its only launch, PERF.md § 7)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted({e.name[:100] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def time_flash_attention(torch, label="StarCoder2", b=1, sq=4096, sk=None, hq=24, hkv=2,
                         d=128, dname="bfloat16", kw=None):
    """Forward and backward kernels, plain versions and SDPA at one training
    shape (StarCoder2's, bf16, causal, unless told otherwise).  Each call
    takes milliseconds, so CUDA events around a few eager calls time the
    card, not the host.  The backward's passes (delta, dK/dV, its
    reduction, dQ) are also timed apart under torch.profiler.
    The bound counts the pairs the mask keeps, at the bf16 tensor-core peak
    for bf16; for float32 at the TF32 tensor-core peak with each product
    taken three times (3xTF32, as the kernels take it), beside the bound at
    the float32 peak of the CUDA cores (FFMA).  The kernels SDPA launches
    are printed by name."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_fwd,
                                                     flash_attention_fwd_ref)

    sk = sq if sk is None else sk
    kw = dict(causal=True) if kw is None else kw
    dtype = getattr(torch, dname)
    q, k, v, g = flash_inputs(torch, 500, b, sq, sk, hq, hkv, d, dtype)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    fwd_ms = eager_ms(torch, lambda i: flash_attention_fwd(q, k, v, **kw), 1, iters=10,
                      repeats=3)
    bwd_ms = eager_ms(torch, lambda i: flash_attention_bwd(q, k, v, out, lse, g, **kw), 1,
                      iters=4, repeats=3)
    parts = kernel_ms_by_group(
        torch, lambda: flash_attention_bwd(q, k, v, out, lse, g, **kw), 5,
        {"delta": "flash_bwd_delta", "dkdv": "flash_bwd_dkdv", "reduce": "flash_bwd_reduce",
         "dq": "flash_bwd_dq"}, once_per_call=True)
    fwd_plain = eager_ms(torch, lambda i: flash_attention_fwd_ref(q, k, v, **kw), 1,
                         iters=3, repeats=3)
    bwd_plain = eager_ms(torch, lambda i: flash_attention_bwd_ref(q, k, v, out, lse, g, **kw),
                         1, iters=2, repeats=3)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    gs = g.transpose(1, 2)
    prefix = kw.get("prefix_len", 0)
    window = kw.get("window", 0)
    causal = kw.get("causal", True)
    # the (query, key) pairs the mask keeps; SDPA takes a window or a
    # prefix-LM mask as an explicit boolean mask
    i = torch.arange(sq, device="cuda")[:, None]
    j = torch.arange(sk, device="cuda")[None, :]
    keep = (i >= j) if causal else torch.ones((sq, sk), dtype=torch.bool, device="cuda")
    if window:
        keep &= i - j < window
    if causal and prefix:
        keep |= j < prefix
    mask = keep if window or (causal and prefix) else None

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              is_causal=causal and mask is None,
                                              enable_gqa=hq != hkv)

    def sdpa_both():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), gs)

    lib_fwd = eager_ms(torch, lambda i: sdpa(), 1, iters=10, repeats=3)
    lib_both = eager_ms(torch, lambda i: sdpa_both(), 1, iters=10, repeats=3)
    lib_bwd = lib_both - lib_fwd
    print(f"sdpa {label} {dname}: a forward and backward launch "
          f"{kernel_names(torch, sdpa_both)}")
    pairs = b * hq * int(keep.sum().item())
    elt = q.element_size()
    # the least time the card could take: bf16 at its tensor-core peak,
    # float32 as three TF32 products at the TF32 peak
    peak = BF16_FLOPS if dname == "bfloat16" else TF32_FLOPS / TF32_SPLIT
    qo = elt * b * sq * hq * d                 # bytes of one (B, Sq, Hq, D) tensor
    kv = elt * b * sk * hkv * d                # ... of one (B, Sk, Hkv, D) tensor
    rows = 4 * b * hq * sq                     # ... of one fp32 (B, Hq, Sq) tensor
    part = 4 * b * sk * hq * d                 # ... of one fp32 (B, Sk, Hq, D) partial
    work = [("fwd", fwd_ms, fwd_plain, lib_fwd, 4 * pairs * d, 2 * qo + 2 * kv + rows),
            ("bwd", bwd_ms, bwd_plain, lib_bwd, 10 * pairs * d, 4 * qo + 4 * kv + rows),
            # each pass with the work it does (dK/dV and dQ recompute the scores)
            ("bwd delta", parts["delta"], None, None, 2 * b * sq * hq * d, 2 * qo + rows),
            ("bwd dK/dV", parts["dkdv"], None, None, 8 * pairs * d,
             2 * qo + 2 * kv + 2 * rows + 2 * part),
            ("bwd reduce", parts["reduce"], None, None, 2 * b * sk * hq * d, 2 * part + 2 * kv),
            ("bwd dQ", parts["dq"], None, None, 6 * pairs * d, 3 * qo + 2 * kv + 2 * rows)]
    res = {}
    for name, ms, plain, lib, flops, nbytes in work:
        if not ms:      # a pass this path does not run (the fp32 kernels reduce nothing)
            print(f"time flash_attention {name} {label}: no such kernel in this path")
            continue
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        tail = (f"plain {plain:.3f} ms, sdpa {lib:.3f} ms" if plain is not None else
                f"sdpa's whole backward {lib_bwd:.3f} ms")
        ffma_ms = max(flops / FP32_FLOPS, t_bytes) * 1e3 if dname == "float32" else None
        ffma = "" if ffma_ms is None else f"; FFMA bound {ffma_ms:.3f} ms at 67 TFLOP/s"
        print(f"time flash_attention {name} {label}: B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} "
              f"D={d} {dname} {', '.join(f'{k_}={v_}' for k_, v_ in kw.items())}: kernel "
              f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s), "
              f"bound {bound_ms:.3f} ms ({by}, {flops / 1e9:.1f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB{ffma}), {tail}")
        res[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": lib}
        if ffma_ms is not None:
            res[name]["ffma_bound_ms"] = ffma_ms
    del q, k, v, g, out, lse, qs, ks, vs, gs, keep, mask
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ ssd scan


def ssd_inputs(torch, seed, bt, s, h, p, n, dtype, dt_scale=1.0, strided=False):
    """Inputs as tests/test_kernels.py makes them: dt from softplus, A =
    -exp(.), x, B and C scaled down; ``dt_scale`` < 1 slows the decay so
    that the state carried across chunks matters.  ``strided`` makes x, B
    and C slices of wider tensors and dt a transposed view."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    w = 2 if strided else 1
    x = (rand(bt, s, h, w * p) * 0.5).to(dtype)[..., :p]
    dt = torch.nn.functional.softplus(rand(bt, h, s).transpose(1, 2) if strided
                                      else rand(bt, s, h)) * dt_scale
    A = -torch.exp(rand(h) * 0.3)
    B = (rand(bt, s, w * n) * 0.3).to(dtype)[..., (w - 1) * n:]
    C = (rand(bt, s, n + 8 * (w - 1)) * 0.3).to(dtype)[..., 8 * (w - 1):]
    return x, dt, A, B, C


def check_ssd_scan(torch):
    """Forward and backward kernels against the plain versions on the same
    inputs, in float32 and bfloat16, with y in x's dtype and (the model's
    path) in float32."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_fwd,
                                              ssd_scan_ref)

    cases = [  # (label, Bt, S, H, P, N, chunk, dt scale, strided views)
        ("sweep 1", 2, 64, 3, 16, 8, 16, 1.0, False),
        ("sweep 2", 1, 256, 2, 32, 16, 64, 1.0, False),
        ("sweep 3", 2, 128, 4, 64, 32, 128, 1.0, False),
        ("N=128 slow decay", 3, 512, 4, 64, 128, 128, 0.02, False),
        ("one chunk S=96", 4, 96, 2, 64, 128, 128, 0.1, False),
        ("ragged sizes", 2, 120, 3, 40, 72, 40, 0.1, False),
        ("strided views", 2, 256, 3, 32, 64, 64, 0.1, True),
        ("Mamba2-780m train", 4, 4096, 48, 64, 128, 128, 1.0, False),
        # the edges of the bf16 forward's grids: an odd head count, a state
        # carried through 128 chunks, Bt x nc below the SM count (8 head
        # groups of the output kernel) and far above it (1 group)
        ("odd heads H=7", 2, 512, 7, 64, 128, 128, 0.1, False),
        ("128 chunks slow decay", 1, 16384, 4, 64, 128, 128, 0.02, False),
        ("Bt x nc below the SMs", 1, 1024, 8, 64, 128, 128, 1.0, False),
        ("Bt x nc far above the SMs", 8, 8192, 4, 64, 128, 64, 1.0, False),
    ]
    bf, f32 = torch.bfloat16, torch.float32
    errs = {"fwd": 0.0, "bwd": 0.0}
    for xdt, ydt in ((f32, f32), (bf, bf), (bf, f32)):
        dname = "bfloat16" if bf in (xdt, ydt) else "float32"
        tol = SSD_TOL[dname]
        for seed, (label, bt, s, h, p, n, chunk, dts, strided) in enumerate(cases):
            x, dt, A, B, C = ssd_inputs(torch, seed, bt, s, h, p, n, xdt, dts, strided)
            gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
            dy = torch.randn((bt, s, h, p), generator=gen, device="cuda").to(ydt)
            y, states, T = ssd_scan_fwd(x, dt, A, B, C, chunk=chunk, out_dtype=ydt)
            grads = ssd_scan_bwd(x, dt, A, B, C, dy, states, T, chunk=chunk)
            ref = ssd_scan_ref(x, dt, A, B, C, chunk, ydt)
            ref_grads = ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk)
            torch.cuda.synchronize()
            e_y = (y.float() - ref.float()).abs().max().item()
            ok = (y.dtype == ydt and y.shape == x.shape
                  and torch.allclose(y.float(), ref.float(), atol=tol, rtol=tol))
            rel = []
            for t, g, rg in zip((x, dt, A, B, C), grads, ref_grads):
                top = rg.float().abs().max().item()
                err = (g.float() - rg.float()).abs().max().item()
                rel.append(err / max(1.0, top))
                ok = ok and g.dtype == t.dtype and g.shape == t.shape and \
                    math.isfinite(err) and err <= tol * max(1.0, top)
                errs["bwd"] = max(errs["bwd"], err)
            errs["fwd"] = max(errs["fwd"], e_y)
            print(f"ssd_scan {label} x {xdt} y {ydt}: y max_abs_err {e_y:.3e} (tol {tol}); "
                  f"dx/ddt/dA/dB/dC err / max(1, max|grad|) "
                  + " ".join(f"{r:.2e}" for r in rel) + f" (tol {tol}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ssd_scan disagrees with its plain version on {label} "
                                     f"x {xdt} y {ydt}")
            if label == "Mamba2-780m train" and (xdt, ydt) == (bf, f32):
                scores_bf16_reading(torch, x, dt, A, B, C, dy, chunk, ref_grads, rel)
            del x, dt, A, B, C, dy, y, states, T, grads, ref, ref_grads
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def scores_bf16_reading(torch, x, dt, A, B, C, dy, chunk, ref_grads, kernel_rel):
    """What one bf16 copy of C B^T per chunk, shared by every head, would
    cost in accuracy: the plain backward with C B^T rounded to bf16 before
    the decays (its gradient passes through the rounding unchanged) against
    the exact plain backward, beside the kernel's error.  A reading for
    PERF.md; it checks nothing."""
    from torch.overrides import TorchFunctionMode

    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref

    class RoundScores(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.einsum and args[0] == "bcin,bcjn->bcij":   # C B^T
                out = out + (out.to(torch.bfloat16).float() - out).detach()
            return out

    with RoundScores():
        rounded = ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk)
    rel = [(g.float() - rg.float()).abs().max().item() / max(1.0, rg.float().abs().max().item())
           for g, rg in zip(rounded, ref_grads)]
    print("ssd_scan Mamba2-780m train, plain backward with C B^T in bf16: dx/ddt/dA/dB/dC "
          "err / max(1, max|grad|) " + " ".join(f"{r:.2e}" for r in rel)
          + "; the kernel's " + " ".join(f"{r:.2e}" for r in kernel_rel))
    del rounded


def train_mamba_reduced_against_cpu(torch):
    """3 AdamW steps of reduced Mamba-2 in float32 on the CPU (plain
    versions) and on the card (kernels), from the same weights; then a few
    lockstep decode steps on both, whose tokens agree."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.models import init_params
    from repro_torch.train import (OptConfig, TrainConfig, init_opt_state,
                                   make_train_step, synthetic_batch)

    cfg = get_arch("mamba2").reduced()
    tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=2))
    cpu_model = init_params(cfg, torch.Generator().manual_seed(5), device="cpu",
                            dtype=torch.float32)
    card_model = copy.deepcopy(cpu_model).to("cuda")
    states = {dev: {"params": m, "opt": init_opt_state(m, tc.opt)}
              for dev, m in (("cpu", cpu_model), ("cuda", card_model))}
    step = make_train_step(cfg, tc)
    fwd0, bwd0 = ssd_scan.launches, ssd_scan_bwd.launches
    losses = {"cpu": [], "cuda": []}
    for i in range(3):
        host = synthetic_batch(cfg, i, 4, 64)
        for dev, state in states.items():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            states[dev], m = step(state, batch)
            losses[dev].append(float(m["loss"]))
    if ssd_scan.launches == fwd0 or ssd_scan_bwd.launches == bwd0:
        raise AssertionError("reduced Mamba-2 training on the card launched no SSD kernel")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cpu_p = dict(cpu_model.named_parameters())
    param_err = max((p.detach().cpu() - cpu_p[n].detach()).abs().max().item()
                    for n, p in card_model.named_parameters())
    ok = loss_err <= TRAIN_TOL["loss_rel"] and param_err <= TRAIN_TOL["param_abs"]
    print(f"reference: reduced {cfg.name}, float32, 3 AdamW steps: losses card "
          f"{losses['cuda']} cpu {losses['cpu']}, max loss rel err {loss_err:.2e} "
          f"(tol {TRAIN_TOL['loss_rel']}), max weight abs err {param_err:.2e} (tol "
          f"{TRAIN_TOL['param_abs']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("reduced Mamba-2 training: card and CPU disagree")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 12))
    out = {dev: lockstep_tokens(torch, m, toks)
           for dev, m in (("cpu", cpu_model), ("cuda", card_model))}
    if out["cpu"] != out["cuda"]:
        raise AssertionError(f"reduced Mamba-2 lockstep decode: card {out['cuda']} != "
                             f"cpu {out['cpu']}")
    print(f"reference: reduced {cfg.name}, float32, 12 lockstep decode steps of 3 lanes: "
          f"card tokens equal the CPU's")


def ssd_flops(bt, s, h, p, n, q):
    """Operations of one SSD-scan forward: per (batch, chunk, head) the
    causal half of C B^T and of the intra-chunk product, the inter-chunk
    output and the chunk state, two flops per multiply-add."""
    tri = q * (q + 1) // 2
    return 2 * bt * (s // q) * h * (tri * n + tri * p + 2 * q * n * p)


def train_mamba_full(torch, batch=4, seq=4096, timed=3):
    """Mamba-2 training main path: full Mamba2-780m, bf16, remat, AdamW."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.train import (TrainConfig, init_train_state, make_train_step,
                                   synthetic_batch)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("mamba2")
    tc = TrainConfig(remat=True)
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, 0, device="cuda", dtype=torch.bfloat16)
    model = state["params"]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"train: {cfg.name}, {len(model.layers)} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B parameters, AdamW state made in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated")
    step = make_train_step(cfg, tc)

    def batch_at(i):
        host = synthetic_batch(cfg, i, batch, seq)
        return {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}

    state, m = step(state, batch_at(0))                      # warm-up
    torch.cuda.synchronize()
    print(f"train: warm-up step loss {float(m['loss']):.4f} grad_norm "
          f"{float(m['grad_norm']):.4f}")
    watch = {"embed": model.embed, "w_x0": model.layers[0].ssd["w_x"],
             "A_log0": model.layers[0].ssd["A_log"],
             "out_proj47": model.layers[-1].ssd["out_proj"]}
    before = {n: p.detach()[:8].clone() for n, p in watch.items()}
    batches = [batch_at(1 + i) for i in range(timed)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = 0
    ssd_scan_bwd.launches = 0
    times, metrics = [], []
    for b in batches:
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        metrics.append({k: float(v) for k, v in m.items()})
    fwd, bwd = ssd_scan.launches, ssd_scan_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    if fwd != 2 * layers * timed or bwd != layers * timed:
        raise AssertionError(f"ssd_scan launched {fwd} forward and {bwd} backward in "
                             f"{timed} steps of {layers} layers with remat; want "
                             f"{2 * layers * timed} and {layers * timed}")
    if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"]) for x in metrics):
        raise AssertionError(f"non-finite loss or grad norm: {metrics}")
    changed = {n: not torch.equal(before[n], p.detach()[:8]) for n, p in watch.items()}
    if not all(changed.values()):
        raise AssertionError(f"weights did not change: {changed}")
    tokens = batch * seq
    step_s = statistics.median(times)
    ssd_fwd = ssd_flops(batch, seq, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                        cfg.ssm_chunk)
    model_flops = 6 * n_params * tokens + 3 * ssd_fwd * layers
    flop_ms = model_flops / BF16_FLOPS * 1e3
    # AdamW reads and writes fp32 master, m and v and reads the grads, once
    opt_bytes = n_params * (3 * 4 * 2 + 2 + 2)
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    mfu = model_flops / (step_s * BF16_FLOPS)
    print(f"train: {timed} timed steps of B={batch} S={seq}: "
          + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms; median "
          f"{step_s * 1e3:.1f} ms per step, {tokens / step_s:.0f} tok/s, MFU "
          f"{100 * mfu:.2f}% ({model_flops / 1e12:.2f} TFLOP per step at 989 TFLOP/s, "
          f"of which SSD {3 * ssd_fwd * layers / 1e12:.2f}); bound {flop_ms + opt_ms:.1f} ms "
          f"per step ({flop_ms:.1f} ms of FLOPs + {opt_ms:.1f} ms of optimizer bytes); peak "
          f"memory {peak / 1e9:.2f} GB")
    print("train: losses " + ", ".join(f"{x['loss']:.4f}" for x in metrics)
          + "; grad norms " + ", ".join(f"{x['grad_norm']:.4f}" for x in metrics)
          + f"; weights changed {changed}")
    print(f"train: ssd_scan launches {fwd} forward = 2 x {layers} layers x {timed} steps, "
          f"{bwd} backward = {layers} x {timed}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, m = step(state, batch_at(1 + timed))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    summarize_profile(torch, prof, wall_ms, 1, f"1 Mamba-2 training step of B={batch} S={seq}",
                      {"ssd fwd states": "ssd_fwd_states", "ssd fwd out": "ssd_fwd_out",
                       "ssd bwd dstates": "ssd_state_mma", "ssd bwd scan": "ssd_scan_kernel",
                       "ssd bwd heads": "ssd_bwd_heads", "ssd bwd reduce": "ssd_reduce",
                       "cuBLAS GEMM": "nvjet"})
    del state, model, step, batches, watch, before, prof
    gc.collect()
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd, "ms_per_step": step_s * 1e3,
            "tok_per_s": tokens / step_s, "mfu": mfu, "peak_gb": peak / 1e9}


def decode_lockstep(torch, cfg=None, lanes=8, prompt_len=32, new=32):
    """Greedy decode of a full recurrent config (Mamba2-780m unless ``cfg``
    is given) through decode_step, every lane at the same position (no
    engine: ServeEngine refuses recurrent configs).  Each step launches
    flash-decode once per attention layer; every recurrent state stays
    finite (the SSD state float32, the RG-LRU state in the cache's bf16)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import decode_step, init_cache, init_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg or get_arch("mamba2")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        dtype=torch.bfloat16)
    cache = init_cache(model, lanes, prompt_len + new)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (lanes, prompt_len))
    torch.cuda.synchronize()
    decode_attention.launches = 0
    t0 = time.perf_counter()
    for i in range(prompt_len):
        nxt, cache = decode_step(model, cache, prompts[:, i:i + 1], np.full(lanes, i))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [nxt.cpu().numpy()]
    for j in range(new - 1):
        nxt, cache = decode_step(model, cache, out[-1][:, None], np.full(lanes, prompt_len + j))
        out.append(nxt.cpu().numpy())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = decode_attention.launches
    toks = np.stack(out, 1)
    if toks.shape != (lanes, new) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"lockstep decode: bad tokens {toks.shape} in "
                             f"[{toks.min()}, {toks.max()}]")
    states = {i: c.get("state", c.get("h")) for i, c in enumerate(cache)
              if "state" in c or "h" in c}
    want_dtype = {i: torch.float32 if "state" in cache[i] else torch.bfloat16 for i in states}
    bad = [i for i, st in states.items() if st.dtype != want_dtype[i]
           or not bool(torch.isfinite(st).all())]
    if bad:
        raise AssertionError(f"lockstep decode: recurrent state of layers {bad} is not finite "
                             f"or not in its dtype")
    steps = prompt_len + new - 1
    per_step = attention_layers(cfg)
    if launches != per_step * steps:
        raise AssertionError(f"decode_attention launched {launches} times in {steps} lockstep "
                             f"steps of {per_step} attention layers")
    ms = (t2 - t1) / (new - 1) * 1e3
    print(f"decode: {cfg.name} lockstep, {lanes} lanes, {prompt_len} prompt + {new} new "
          f"tokens: {(t1 - t0) / prompt_len * 1e3:.3f} ms per prefill step, "
          f"{ms:.3f} ms per decode step ({lanes * (new - 1) / (t2 - t1):.1f} tok/s), "
          f"{steps} steps; tokens in [0, {cfg.vocab_size}), {len(states)} recurrent states "
          f"finite ({', '.join(sorted({str(t) for t in want_dtype.values()}))}); "
          f"decode_attention launches {launches} = {per_step} x {steps}; lane 0: "
          f"{toks[0, :8].tolist()}")
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "ms_per_step": ms}


def time_ssd_scan(torch, bt=4, s=4096, h=48, p=64, n=128, q=128):
    """Forward and backward kernels and plain versions at Mamba2-780m's
    training shape, as the model calls them: x, B, C bf16, y float32, each
    direction's kernels also apart (torch.profiler) and each direction
    bit-identical when run twice.  A backward call takes milliseconds, so
    CUDA events around eager calls time the card; a forward call is short
    enough for the host's launch cost to show there, so it is timed in a
    CUDA graph as well.  No single PyTorch call computes the scan, so there
    is no library time."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_fwd,
                                              ssd_scan_ref)

    f32 = torch.float32
    x, dt, A, B, C = ssd_inputs(torch, 600, bt, s, h, p, n, torch.bfloat16)
    dy = torch.randn((bt, s, h, p), device="cuda", dtype=f32)
    y, states, T = ssd_scan_fwd(x, dt, A, B, C, chunk=q, out_dtype=f32)
    fwd_eager = eager_ms(torch, lambda i: ssd_scan_fwd(x, dt, A, B, C, chunk=q, out_dtype=f32),
                         1, iters=10, repeats=3)
    fwd_ms = graph_ms(torch, lambda i: ssd_scan_fwd(x, dt, A, B, C, chunk=q, out_dtype=f32), 1,
                      iters=5, repeats=3)
    bwd_ms = eager_ms(torch, lambda i: ssd_scan_bwd(x, dt, A, B, C, dy, states, T, chunk=q), 1,
                      iters=5, repeats=3)
    # the forward's kernels apart, by name (bf16: the state pass and the
    # outputs)
    fwd_phases = kernel_ms_by_group(
        torch, lambda: ssd_scan_fwd(x, dt, A, B, C, chunk=q, out_dtype=f32), 5)
    print("time ssd_scan fwd phases: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in fwd_phases.items())
          + f" (sum {sum(fwd_phases.values()):.3f} ms); the call {fwd_ms:.3f} ms on the card "
          f"(CUDA graph), {fwd_eager:.3f} ms eager")
    again = ssd_scan_fwd(x, dt, A, B, C, chunk=q, out_dtype=f32)
    same = all(torch.equal(a, b) for a, b in zip((y, states, T), again))
    print(f"ssd_scan Mamba2-780m bf16 forward run twice: y, states, T "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("ssd_scan forward is not deterministic")
    del again
    # the backward's phases apart: chunk dstates, reverse scan, per-chunk
    # gradients, reduction
    phases = kernel_ms_by_group(
        torch, lambda: ssd_scan_bwd(x, dt, A, B, C, dy, states, T, chunk=q), 5,
        {"state": "ssd_state", "scan": "ssd_scan_kernel", "bwd": "ssd_bwd",
         "reduce": "ssd_reduce"})
    print("time ssd_scan bwd phases: " + ", ".join(f"{k} {v:.3f} ms" for k, v in phases.items())
          + f" (sum {sum(phases.values()):.3f} ms)")
    # no atomics: the same inputs give the same bits
    first = ssd_scan_bwd(x, dt, A, B, C, dy, states, T, chunk=q)
    second = ssd_scan_bwd(x, dt, A, B, C, dy, states, T, chunk=q)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"ssd_scan Mamba2-780m bf16 backward run twice: dx, ddt, dA, dB, dC "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("ssd_scan backward is not deterministic")
    del first, second
    fwd_plain = eager_ms(torch, lambda i: ssd_scan_ref(x, dt, A, B, C, q, f32), 1,
                         iters=2, repeats=3)
    bwd_plain = eager_ms(torch, lambda i: ssd_scan_bwd_ref(x, dt, A, B, C, dy, q), 1,
                         iters=1, repeats=3)
    ins = bt * s * (h * p * 2 + h * 4 + 2 * n * 2) + h * 4       # x, dt, B, C (A)
    flops = ssd_flops(bt, s, h, p, n, q)
    res = {}
    # forward writes y (f32); the backward reads dy (f32) and writes dx, ddt,
    # dA, dB, dC in the inputs' types, and does twice the forward's products
    for name, ms, plain, ops, nbytes in (
            ("fwd", fwd_ms, fwd_plain, flops, ins + bt * s * h * p * 4),
            ("bwd", bwd_ms, bwd_plain, 2 * flops, 2 * ins + bt * s * h * p * 4)):
        t_ops, t_bytes = ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"time ssd_scan {name}: Bt={bt} S={s} H={h} P={p} N={n} chunk={q}, x/B/C bf16, "
              f"y f32: kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.0f} "
              f"GB/s), bound {bound_ms:.3f} ms ({by}: {ops / 1e9:.1f} GFLOP at 989 TFLOP/s, "
              f"{nbytes / 1e6:.1f} MB at 3.35 TB/s); plain {plain:.3f} ms; no library call")
        res[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": None}
    res["fwd"]["phases_ms"] = fwd_phases
    res["fwd"]["eager_ms"] = fwd_eager
    res["bwd"]["phases_ms"] = phases
    del x, dt, A, B, C, dy, y, states, T
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ sweep slice


SWEEP_NODES = 10_000             # benchmarks/scale.py: 10,000 nodes x 4 GPUs
SWEEP_BLOCK = 65_536             # snapshots per device block of the main path


# lengths at the scan routes' thresholds (the warp route's team widths, one
# warp tile, the block route past 1024 entries) and row counts below and
# above the persistent grid and the block route's 4224 rows, for the
# route-boundary cases of scan_cases
SCAN_LENGTHS = (1, 3, 4, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                511, 512, 513, 1023, 1024, 1025, 8191, 8192, 8193)
SCAN_ROWS = (1, 7, 131, 1000, 131072)


def scan_cases(torch):
    """(label, input) pairs on the card: tests/test_prefix_scan.py's shape
    sweep, empty shapes, one row of 2^20, bool/uint8/int32 (int32 with sums
    that wrap), 3-D leading axes, strided and offset views, the sweep's
    block; then the routes' boundaries: every length of SCAN_LENGTHS at
    every row count of SCAN_ROWS in bool, uint8 and int32 drawn over the
    whole int32 range (so sums pass 2^31 and wrap; at 131,072 rows bool
    only past 513 entries, for memory), and offset base pointers at 7 and
    131 rows of every length (the element-access form of each route)."""
    gen = torch.Generator(device="cuda").manual_seed(13)

    def mask(shape, p=0.3):
        return torch.rand(shape, generator=gen, device="cuda") < p

    def ints(shape, lo=-1000, hi=1000):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    def wide(shape):
        return ints(shape, -(1 << 31) + 1, (1 << 31) - 1)

    shapes = [(1, 0), (1, 1), (3, 7), (64, 8), (16, 128), (8, 129), (8, 300), (2, 1024),
              (4, 3, 40), (2, 3, 4, 8), (0, 5), (0, 0), (1, 257), (5, 1), (7, 4099)]
    cases = []
    for shape in shapes:
        cases += [(f"bool {shape}", mask(shape)),
                  (f"uint8 {shape}", ints(shape, 0, 256).to(torch.uint8)),
                  (f"int32 {shape}", ints(shape))]
    base = mask((33, 44))
    flat = mask((33 * 44 + 1,))
    base32 = ints((33, 44))
    flat32 = ints((33 * 44 + 1,))
    cases += [
        ("bool one row of 2^20", mask((1, 1 << 20))),
        ("bool dense (4, 2^20)", torch.ones((4, 1 << 20), dtype=torch.bool, device="cuda")),
        ("int32 (4, 4096) sums past 2^31", ints((4, 4096), 1 << 20, 1 << 21)),
        ("bool 3-D (6, 50, 720)", mask((6, 50, 720), 0.07)),
        ("bool column slice [:, 3:35]", base[:, 3:35]),
        ("bool transpose", base.T),
        ("bool offset base pointer", flat[1:].view(33, 44)),
        ("int32 column slice [:, 1:41]", base32[:, 1:41]),
        ("int32 offset base pointer", flat32[1:].view(33, 44)),
        (f"bool sweep block ({SWEEP_BLOCK}, {SWEEP_NODES}) at 7%",
         mask((SWEEP_BLOCK, SWEEP_NODES), 0.07)),
    ]
    return cases


def scan_boundary_cases(torch):
    """scan_cases' route-boundary cases, made one at a time (the largest,
    131,072 rows of 8193, is 1.07 G elements)."""
    gen = torch.Generator(device="cuda").manual_seed(34)
    draw = {
        "bool": lambda shape: torch.rand(shape, generator=gen, device="cuda") < 0.3,
        "uint8": lambda shape: torch.randint(0, 256, shape, generator=gen, device="cuda",
                                             dtype=torch.uint8),
        "int32": lambda shape: torch.randint(-(1 << 31) + 1, (1 << 31) - 1, shape,
                                             generator=gen, device="cuda", dtype=torch.int32),
    }
    for rows in SCAN_ROWS:
        for length in SCAN_LENGTHS:
            for dtype, fn in draw.items():
                if rows == SCAN_ROWS[-1] and length > 513 and dtype != "bool":
                    continue
                yield f"{dtype} ({rows}, {length})", fn((rows, length))
                if rows == 1000 and length > 1024:
                    # the block route's last row count and the warp route's first
                    for more in (4223, 4224):
                        yield f"{dtype} ({more}, {length})", fn((more, length))
                if rows in (7, 131):
                    yield (f"{dtype} ({rows}, {length}) offset base pointer",
                           fn((rows * length + 1,))[1:].view(rows, length))


def route_label(route) -> str:
    """A scan route as the histogram prints it: warp16/vec, block/elem, ..."""
    return (f"{route.route}{route.lanes if route.route == 'warp' else ''}/"
            f"{'vec' if route.vec else 'elem'}")


def scan_kernel_routes(names):
    """(route label, input kind) of each prefix-scan kernel in ``names``
    (profiler kernel names, demangled or not)."""
    import re

    out = set()
    for name in names:
        m = re.search(r"prefix_scan_(warp|block)_kernel<(unsigned char|int), (?:\(int\))?"
                      r"(?:(\d+), (?:\(bool\))?)?(true|false|1|0)>", name)
        if m:
            route, ctype, lanes, vec = m.groups()
            kind = 0 if ctype == "unsigned char" else 1
            vec = vec in ("true", "1")
        else:
            m = re.search(r"prefix_scan_(warp|block)_kernelI([hi])(?:Li(\d+)E)?Lb([01])E", name)
            if not m:
                continue
            route, ctype, lanes, vec = m.groups()
            kind = 0 if ctype == "h" else 1
            vec = vec == "1"
        out.add((f"{route}{lanes or ''}/{'vec' if vec else 'elem'}", kind))
    return out


def scan_kernel_events(torch, fn, tries=5):
    """{name: [device us of each launch]} of the prefix-scan kernels ``fn``
    launches, from torch.profiler: the union over up to ``tries`` profiles
    of four calls each after a warm-up call, stopping at the first that
    recorded one (an isolated profile can miss launches, PERF.md § 7)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "prefix_scan_" in e.name:
                out.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
        if out:
            break
    return out


def check_prefix_scan(torch):
    """The prefix-scan kernel against its plain version on the card:
    bit-equal (tolerance 0) on every case of scan_cases and
    scan_boundary_cases; then, by the profiler's kernel names, each route's
    kernel launched at a shape of that route."""
    from repro_torch.kernels.prefix_scan import mask_cumsum, prefix_scan, prefix_scan_ref
    from repro_torch.kernels.prefix_scan.prefix_scan import route_of

    t0 = time.perf_counter()
    worst, n_cases, routes = 0, 0, {}
    for label, x in [*scan_cases(torch), *scan_boundary_cases(torch)]:
        out = prefix_scan(x)
        ref = prefix_scan_ref(x)
        ok = (out.dtype == torch.int32 and out.shape == x.shape and out.device == x.device
              and torch.equal(out, ref))
        err = 0
        if not ok and out.shape == ref.shape and out.numel():
            err = (out.long() - ref.long()).abs().max().item()
        if x.dtype == torch.bool:
            ok = ok and torch.equal(mask_cumsum(x), ref)
        if x.numel():
            key = route_label(route_of(x.contiguous()))
            routes[key] = routes.get(key, 0) + 1
        if "sweep block" in label or "2^20" in label or not ok:
            print(f"prefix_scan {label}: max_abs_err {err} (tol 0) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"prefix_scan disagrees with its plain version on {label}")
        worst, n_cases = max(worst, err), n_cases + 1
        del x, out, ref
    try:
        mask_cumsum(torch.ones((2, 4), dtype=torch.int32, device="cuda"))
    except TypeError:
        pass
    else:
        raise AssertionError("mask_cumsum took an int32 tensor")
    torch.cuda.empty_cache()
    print(f"prefix_scan: {n_cases} cases bit-equal to torch.cumsum on the card; cases by "
          f"route: " + ", ".join(f"{k} {v}" for k, v in sorted(routes.items())))

    # each route's kernel by name, at a shape of that route
    gen = torch.Generator(device="cuda").manual_seed(35)
    named = [torch.rand((131072, 64), generator=gen, device="cuda") < 0.07,
             torch.rand((1024, DC_NODES), generator=gen, device="cuda") < 0.07,
             torch.rand((8192, 1000), generator=gen, device="cuda") < 0.07,
             torch.randint(0, 9, (1000, 3), generator=gen, device="cuda", dtype=torch.uint8),
             torch.randint(0, 9, (1000, 64), generator=gen, device="cuda", dtype=torch.int32),
             torch.randint(0, 9, (131 * 8193 + 1,), generator=gen, device="cuda",
                           dtype=torch.int32)[1:].view(131, 8193)]
    launches = prefix_scan.launches
    for x in named:
        want = {(route_label(route_of(x)), 0 if x.element_size() == 1 else 1)}
        ran = scan_kernel_routes(scan_kernel_events(torch, lambda: prefix_scan(x)))
        print(f"prefix_scan kernel at {tuple(x.shape)} {str(x.dtype)[6:]}: ran {sorted(ran)}, "
              f"route {sorted(want)} {'ok' if ran == want else 'FAIL'}")
        if ran != want:
            raise AssertionError(f"prefix_scan at {tuple(x.shape)} ran {ran}, not {want}")
    prefix_scan.launches = launches              # these launches are not a main path's
    del named
    torch.cuda.empty_cache()
    print(f"prefix_scan: the checks took {time.perf_counter() - t0:.1f} s")
    return worst


class ScanHistogram:
    """prefix_scan's launches by (rows, length, route) while entered: the
    kernel module's ``launch`` (which every call of the wrapper goes
    through) is replaced by one that records its route and calls through.
    The wrapper's own count, ``prefix_scan.launches``, is untouched."""

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        mod = importlib.import_module("repro_torch.kernels.prefix_scan.prefix_scan")
        self._mod, self._launch = mod, mod.launch

        def counted(x, out, route):
            key = (x.numel() // x.shape[-1], x.shape[-1], route_label(route))
            self.counts[key] = self.counts.get(key, 0) + 1
            return self._launch(x, out, route)

        mod.launch = counted
        return self

    def __exit__(self, *exc):
        self._mod.launch = self._launch

    def add(self, counts):
        for key, n in counts.items():
            self.counts[key] = self.counts.get(key, 0) + n

    def line(self, label):
        total = sum(self.counts.values())
        return (f"prefix_scan histogram, {label}: {total} launches: "
                + ", ".join(f"({r}, {n}) {route} x {c}"
                            for (r, n, route), c in sorted(self.counts.items())))

    def rows(self):
        return [[r, n, route, c] for (r, n, route), c in sorted(self.counts.items())]


def grids_equal(a, b):
    return a.names == b.names and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("total_gpus", "faulty_gpus", "placed_gpus"))


ZOO_TPS = (16, 32, 64, 24)
# the zoo's counter snapshots at chunks of 8192, and the first ZOO_CHUNK1 of
# them (snapshot i is drawn from its own counter) at chunks of 1
ZOO_SNAPSHOTS = 4096
ZOO_CHUNK1 = 256


def zoo_spec(snapshots):
    from repro_torch.core import arch
    from repro_torch.sim import CounterIIDSnapshots, ScenarioSpec

    return ScenarioSpec(num_nodes=SWEEP_NODES,
                        snapshots=CounterIIDSnapshots(0.07, snapshots, 0),
                        tp_sizes=ZOO_TPS, architectures=arch.names())


def zoo_refs():
    """The zoo's numpy grids: {snapshots: (grid, seconds)}."""
    from repro_torch.sim import run_sweep

    out = {}
    for n in (ZOO_SNAPSHOTS, ZOO_CHUNK1):
        t0 = time.perf_counter()
        out[n] = (run_sweep(zoo_spec(n), backend="numpy"), time.perf_counter() - t0)
    return out


def check_sweep_zoo(torch, refs=None):
    """All 13 architectures: torch grids on the card equal the port's numpy
    grids, on the counter stream at 10,000 nodes (4096 snapshots in chunks
    of 8192, the first 256 in chunks of 1), on all-faulty and all-healthy
    rows and on masks narrower and wider than the cluster.  ``refs``: a
    Background of host_refs, which computed the numpy grids beside the
    earlier phases."""
    from repro_torch.core import arch
    from repro_torch.sim import ScenarioSpec, run_sweep

    names = arch.names()
    tps = ZOO_TPS
    zoo = refs.get("zoo") if refs else zoo_refs()
    where = " in a process of its own" if refs else ""
    for n, chunk in ((ZOO_SNAPSHOTS, 8192), (ZOO_CHUNK1, 1)):
        ref, np_s = zoo[n]
        t2 = time.perf_counter()
        got = run_sweep(zoo_spec(n), backend="torch", chunk_snapshots=chunk)
        dt = time.perf_counter() - t2
        if got.backend != "torch" or not grids_equal(got, ref):
            bad = [n for i, n in enumerate(names)
                   if not np.array_equal(got.placed_gpus[i], ref.placed_gpus[i])
                   or not np.array_equal(got.faulty_gpus[i], ref.faulty_gpus[i])]
            raise AssertionError(f"zoo: torch grids at chunk {chunk} differ from numpy for {bad}")
        print(f"zoo: {len(names)} architectures x {n} counter snapshots x {SWEEP_NODES} nodes "
              f"x TP {tps}, chunk {chunk}: torch grids equal numpy ({dt:.2f} s on the card, "
              f"numpy {np_s:.2f} s{where})")
    ref = zoo[ZOO_SNAPSHOTS][0]
    waste = ref.waste_ratio.mean(axis=1)
    print("zoo: mean waste at TP " + "/".join(map(str, tps)) + ": " + "; ".join(
        f"{n} " + "/".join(f"{100 * w:.3f}%" for w in waste[i]) for i, n in enumerate(names)))
    rng = np.random.default_rng(3)
    widths = (SWEEP_NODES * 7 // 8 + 1, SWEEP_NODES, SWEEP_NODES * 9 // 8 + 3)
    for width in widths:
        masks = np.concatenate([np.zeros((1, width), bool), np.ones((1, width), bool),
                                rng.random((62, width)) < 0.07])
        edge = ScenarioSpec(num_nodes=SWEEP_NODES, snapshots=None, tp_sizes=tps,
                            architectures=names)
        a = run_sweep(edge, masks=masks, backend="torch", chunk_snapshots=16)
        b = run_sweep(edge, masks=masks, backend="numpy")
        if not grids_equal(a, b):
            raise AssertionError(f"zoo: masks of width {width}: torch and numpy grids differ")
    print(f"zoo: all-healthy, all-faulty and random rows at widths {widths} on "
          f"{SWEEP_NODES} nodes: torch grids equal numpy")
    t = names.index("tpuv4")
    tp24 = tps.index(24)
    placed, total = int(a.placed_gpus[t, 0, tp24]), int(a.total_gpus[t, tp24])
    print(f"zoo: tpuv4 at TP-24 on an all-healthy cluster places {placed} of {total} GPUs "
          f"(the reference's over-placement, reproduced)")
    if placed <= total:
        raise AssertionError("tpuv4 TP-24: the reference's over-placement did not show")


def check_fig13(torch):
    """Fig. 13 / Table 7: the production-like trace on 720 nodes."""
    from repro_torch.sim import (DEFAULT_ARCHITECTURES, ScenarioSpec, TraceSnapshots,
                                 run_sweep, waste_table)

    spec = ScenarioSpec(num_nodes=720, snapshots=TraceSnapshots(trace_nodes=400, samples=1000,
                                                                seed=1),
                        tp_sizes=(16, 32, 64))
    masks = spec.snapshots.masks(spec.num_nodes)
    got = run_sweep(spec, masks=masks, backend="torch")
    ref = run_sweep(spec, masks=masks, backend="numpy")
    if not grids_equal(got, ref):
        raise AssertionError("Fig. 13: torch and numpy grids differ")
    rows = {r["architecture"]: r for r in waste_table(got) if r["tp_size"] == 32}
    print(f"fig13: {len(DEFAULT_ARCHITECTURES)} architectures x 1000 trace snapshots x 720 "
          f"nodes: torch grids equal numpy; waste at TP-32 (mean/P50/P99):")
    for name in DEFAULT_ARCHITECTURES:
        r = rows[name]
        print(f"fig13:   {name:16s} {100 * r['mean_waste']:7.3f}% {100 * r['p50_waste']:7.3f}% "
              f"{100 * r['p99_waste']:7.3f}%")
    inf, nvl, tpu = (rows[n]["mean_waste"] for n in ("infinitehbd-k3", "nvl-72", "tpuv4"))
    ok = inf < 0.01 and 0.08 < nvl < 0.13 and 0.05 < tpu < 0.10 and inf < tpu < nvl
    print(f"fig13: InfiniteHBD {100 * inf:.2f}% < 1%, NVL-72 {100 * nvl:.2f}% in (8, 13)%, "
          f"TPUv4 {100 * tpu:.2f}% in (5, 10)%, ordered (paper: 0.53%, 10.04%, 7.56%) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Fig. 13 bands or ordering not held")


def _busy_ms(torch, prof):
    """Device busy time (union of kernel intervals) of a profile, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for st, en in spans:
        if cur is None or st > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [st, en]
        else:
            cur[1] = max(cur[1], en)
    return (busy + (cur[1] - cur[0] if cur else 0)) / 1e3


SWEEP_CHECK_ROWS = 16_384


def sweep_spec(n):
    """benchmarks/scale.py's sweep at ``n`` counter snapshots."""
    from repro_torch.sim import CounterIIDSnapshots, ScenarioSpec

    return ScenarioSpec(num_nodes=SWEEP_NODES, snapshots=CounterIIDSnapshots(0.07, n, 5),
                        tp_sizes=(32,), architectures=("infinitehbd-k3", "nvl-72"))


def sweep_ref():
    """The numpy path on host masks of the sweep's first SWEEP_CHECK_ROWS
    snapshots: (grid, seconds)."""
    from repro_torch.sim import run_sweep

    t0 = time.perf_counter()
    return run_sweep(sweep_spec(SWEEP_CHECK_ROWS), backend="numpy"), time.perf_counter() - t0


def sweep_main_path(torch, samples=1_000_000, refs=None):
    """Main path at benchmarks/scale.py's configuration: 1,000,000 counter
    snapshots of 10,000 nodes x 4 GPUs at 7%, seed 5, TP-32, InfiniteHBD-K3
    and NVL-72, masks drawn on the card, blocks of 65,536 snapshots
    (``refs``: a Background of host_refs, which ran the numpy path on the
    first rows)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.prng import counter_masks_at
    from repro_torch.kernels.prefix_scan import prefix_scan
    from repro_torch.sim import run_sweep
    from repro_torch.sim.torch_backend import GridEvaluator, MaskGen, infinitehbd_scans

    spec_of = sweep_spec
    check_rows = SWEEP_CHECK_ROWS
    spec = spec_of(samples)
    scans_per_block = sum(infinitehbd_scans(m) for m in spec.models()
                          if m.name.startswith("infinitehbd"))
    blocks = -(-samples // SWEEP_BLOCK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefix_scan.launches = 0
    t0 = time.perf_counter()
    res = run_sweep(spec, backend="torch", chunk_snapshots=SWEEP_BLOCK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = prefix_scan.launches
    peak = torch.cuda.max_memory_allocated()
    if res.backend != "torch" or res.placed_gpus.shape != (2, samples, 1):
        raise AssertionError(f"main path: backend {res.backend}, grid {res.placed_gpus.shape}")
    if launches != scans_per_block * blocks:
        raise AssertionError(f"prefix_scan launched {launches} times in {blocks} blocks; want "
                             f"{scans_per_block} per block = {scans_per_block * blocks}")
    waste = res.waste_ratio
    inf_waste = float(waste[0, :, 0].mean())
    nvl_waste = float(waste[1, :, 0].mean())
    if not (np.isfinite(waste).all() and 0 <= inf_waste < nvl_waste < 1):
        raise AssertionError(f"main path: waste InfiniteHBD {inf_waste}, NVL-72 {nvl_waste}")
    print(f"sweep: {samples} counter snapshots x {SWEEP_NODES} nodes ({4 * SWEEP_NODES} GPUs) "
          f"at 7%, seed 5, TP-32, infinitehbd-k3 + nvl-72, blocks of {SWEEP_BLOCK} drawn on the "
          f"card: {wall:.3f} s, {samples / wall:.0f} snapshots/s, peak device memory "
          f"{peak / 1e9:.2f} GB; mean waste InfiniteHBD-K3 {100 * inf_waste:.4f}%, NVL-72 "
          f"{100 * nvl_waste:.4f}%")
    print(f"sweep: prefix_scan launches {launches} = {scans_per_block} per block x {blocks} "
          f"blocks")
    # least time for the stream: the threefry draw's int32 operations (77
    # per cipher call of two lanes: 2 key adds, 20 rounds of add, rotate (one
    # funnel shift) and xor, 5 injections of 3 adds) and one compare per
    # node; a fused draw and evaluation need not write the mask to memory
    draw_ops = samples * SWEEP_NODES * (77 / 2 + 1)
    bound_ms = draw_ops / INT32_OPS * 1e3
    print(f"sweep: bound {bound_ms:.1f} ms for the stream (operations: "
          f"{draw_ops / 1e12:.3f} T int32 operations of the draw at "
          f"{INT32_OPS / 1e12:.2f} TOP/s), {samples / bound_ms * 1e3:.0f} snapshots/s")

    head = spec_of(check_rows)
    host, np_s = refs.get("sweep") if refs else sweep_ref()
    small = run_sweep(head, backend="torch", chunk_snapshots=8192)
    for name, other in (("host numpy path", host), ("chunk 8192 torch run", small)):
        if not (np.array_equal(res.placed_gpus[:, :check_rows], other.placed_gpus)
                and np.array_equal(res.faulty_gpus[:, :check_rows], other.faulty_gpus)
                and np.array_equal(res.total_gpus, other.total_gpus)):
            raise AssertionError(f"main path: the first {check_rows} rows differ from the "
                                 f"{name}")
    print(f"sweep: first {check_rows} rows equal the numpy path on host masks "
          f"(counter_fault_masks, {np_s:.2f} s on the host"
          f"{' in a process of its own' if refs else ''}) and a chunk-8192 torch run")

    # where a block's time goes: two whole blocks under the profiler, then
    # the draw alone and the model kernels alone on one block's rows
    models = spec.models()
    ev = GridEvaluator(models, (32,), SWEEP_NODES,
                       gen=MaskGen(samples, SWEEP_NODES, 0.07, 5))
    idx = np.arange(SWEEP_BLOCK, 2 * SWEEP_BLOCK, dtype=np.int64)
    ev.eval_block(idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        for b in (1, 2):
            ev.eval_block(idx + (b - 1) * SWEEP_BLOCK)
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t3) * 1e3 / 2
    prof_block = summarize_profile(torch, prof, 2 * block_ms, 2,
                                   f"2 sweep blocks of {SWEEP_BLOCK} snapshots",
                                   {"prefix scan": "prefix_scan_",
                                    "cummax/cummin": "with_indices"})
    scan_ms = sum(e.time_range.end - e.time_range.start for e in prof.events()
                  if "prefix_scan_" in e.name) / 1e3 / 2
    idx_dev = torch.from_numpy(idx).cuda()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_draw:
        masks = counter_masks_at(idx_dev, SWEEP_NODES, 0.07, 5)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_models:
        out = [k(masks) for k in ev.kernels]
        torch.cuda.synchronize()
    draw_ms, model_ms = _busy_ms(torch, prof_draw), _busy_ms(torch, prof_models)
    busy = draw_ms + model_ms
    print(f"sweep profile: {block_ms:.1f} ms per block under the profiler; mask draw "
          f"{draw_ms:.1f} ms ({100 * draw_ms / busy:.1f}% of device time), model kernels "
          f"{model_ms:.1f} ms ({100 * model_ms / busy:.1f}%) of which prefix scans "
          f"{scan_ms:.2f} ms ({100 * scan_ms / busy:.1f}%), the rest {model_ms - scan_ms:.1f} "
          f"ms ({100 * (model_ms - scan_ms) / busy:.1f}%)")
    del masks, out, idx_dev, ev
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "snaps_per_s": samples / wall, "seconds": wall,
            "bound_ms": bound_ms,
            "peak_gb": peak / 1e9, "inf_waste": inf_waste, "nvl_waste": nvl_waste,
            "block_ms": block_ms, "draw_ms": draw_ms, "model_ms": model_ms,
            "scan_ms": scan_ms, **(prof_block or {})}


def time_scan_shape(torch, label, shape, n_buf=4, seed=21):
    """The prefix-scan kernel at ``shape`` (bool at 7%, as the engines' masks)
    beside the bytes bound (each input byte read once, each int32 written
    once), its plain version (torch.cumsum after a cast to int32) and the
    library call torch.cumsum(..., dtype=torch.int32) on the mask itself:
    device time by CUDA graph over ``n_buf`` distinct inputs (more bytes
    than the 50 MB L2 at every timed shape), and the profiler's device time
    of a launch beside it (the mean of the launches it recorded)."""
    from repro_torch.kernels.prefix_scan import prefix_scan, prefix_scan_ref
    from repro_torch.kernels.prefix_scan.prefix_scan import route_of

    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.rand(shape, generator=gen, device="cuda") < 0.07 for _ in range(n_buf)]
    keep = [None] * n_buf

    def timed(fn):
        # each call's output stays alive until its input comes round again,
        # so the outputs rotate through n_buf + 1 buffers too
        def call(i):
            keep[i] = fn(xs[i])
        ms = graph_ms(torch, call, n_buf)
        keep[:] = [None] * n_buf
        return ms

    launches = prefix_scan.launches
    kernel_ms = timed(prefix_scan)
    events = [us for v in scan_kernel_events(torch, lambda: [prefix_scan(x) for x in xs]).values()
              for us in v]
    device_ms = statistics.mean(events) / 1e3 if events else float("nan")
    prefix_scan.launches = launches              # timing launches are not the main path's
    plain_ms = timed(prefix_scan_ref)
    library_ms = timed(lambda x: torch.cumsum(x, -1, dtype=torch.int32))
    n = xs[0].numel()
    nbytes = n * (1 + 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n / INT32_OPS   # one int32 add per element
    bound_ms = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    route = route_label(route_of(xs[0]))
    print(f"time prefix_scan {label} {tuple(shape)} bool -> int32, route {route}: kernel "
          f"{kernel_ms:.4f} ms by CUDA graph over {n_buf} inputs ({nbytes / kernel_ms / 1e6:.0f} "
          f"GB/s, {100 * bound_ms / kernel_ms:.1f}% of the bound), profiler device time "
          f"{device_ms:.4f} ms a launch; bound {bound_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB at 3.35 "
          f"TB/s); plain (torch.cumsum of the int32 cast) {plain_ms:.4f} ms; library "
          f"torch.cumsum(dtype=int32) {library_ms:.4f} ms")
    del xs
    torch.cuda.empty_cache()
    return {"shape": list(shape), "scan_route": route, "ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms}


def time_prefix_scan(torch, rows=SWEEP_BLOCK, length=SWEEP_NODES):
    """The kernel at the sweep's block (time_scan_shape)."""
    return time_scan_shape(torch, "sweep block", (rows, length))


# ------------------------------------------------------------ DCN and churn slice


DCN_RATIOS = (0.0, 0.03, 0.05, 0.07, 0.10)      # Fig. 17c's fault ratios
DCN_GRIDS = ("groups", "dp_pairs", "crossing_pairs", "crossing_pod_pairs", "feasible",
             "n_constraints")
DC_NODES = 8192                                   # 32,768 GPUs
DC_SAMPLES = 1024                                 # snapshots per fault ratio
DC_TPS = (32, 64)
DC_CHUNK = 1024                                   # rows per device block


def dcn_grids_equal(a, b):
    return a.variants == b.variants and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in DCN_GRIDS)


def placements_equal(a, b):
    return (np.array_equal(a.members, b.members) and np.array_equal(a.feasible, b.feasible)
            and np.array_equal(a.n_constraints, b.n_constraints))


def check_fig17c(torch, device="cuda"):
    """benchmarks/dcn.py's Fig. 17c grid: 2048 nodes, 512-node domains, five
    fault ratios x 100 snapshots, TP-32, all three variants through
    ``run_dcn_sweep(backend="torch")`` on ``device`` (one card, or slices
    of it): every grid equal to the port's numpy grid, the curves equal to
    the reference's recorded BENCH_dcn.json."""
    from repro_torch.dcn import DcnSpec, cross_tor_curve, run_dcn_sweep
    from repro_torch.dcn.torch_backend import num_devices, scans_per_call
    from repro_torch.kernels.prefix_scan import prefix_scan

    spec = DcnSpec(num_nodes=2048, agg_domain=512, fault_ratios=DCN_RATIOS, samples=100,
                   tp_sizes=(32,), job_scale=0.85, seed=3)
    masks = [spec.masks(ri) for ri in range(len(DCN_RATIOS))]
    t0 = time.perf_counter()
    ref = run_dcn_sweep(spec, backend="numpy", masks=masks)
    dt_np = time.perf_counter() - t0
    rows = len(DCN_RATIOS) * spec.samples
    slices = num_devices(device)
    want = scans_per_call(spec.config, 32) * -(-rows // 1024) * slices
    # twice: the first call loads the CUDA modules of every kernel on this
    # path, the second is the steady state
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        prefix_scan.launches = 0
        t1 = time.perf_counter()
        got = run_dcn_sweep(spec, backend="torch", masks=masks, device=device)
        times.append(time.perf_counter() - t1)
        launches = prefix_scan.launches
        if got.backend != "torch" or not dcn_grids_equal(got, ref):
            bad = [f for f in DCN_GRIDS if not np.array_equal(getattr(got, f), getattr(ref, f))]
            raise AssertionError(f"fig17c: torch grids differ from numpy in {bad}")
        if launches != want:
            raise AssertionError(f"fig17c: prefix_scan launched {launches} times, want {want}")
    dt = times[1]
    recorded = json.loads((ROOT / "BENCH_dcn.json").read_text())
    print(f"fig17c: {rows} snapshots x 2048 nodes, agg 512, TP-32, 3 variants, {slices} "
          f"slice(s) of the card: torch grids "
          f"equal numpy on groups, dp_pairs, crossing_pairs, crossing_pod_pairs, feasible, "
          f"n_constraints, twice (torch first call {times[0]:.3f} s, then {dt:.3f} s; numpy "
          f"{dt_np:.3f} s); prefix_scan launches {launches} a run")
    for variant in got.variants:
        curve = cross_tor_curve(got, variant)
        same = {f"{r:.2f}": s for r, s in curve.items()} == recorded[f"curve_{variant}"]
        print(f"fig17c: {variant:12s} cross-ToR share " + ", ".join(
            f"{100 * r:.0f}%: " + ("infeasible" if s is None else f"{s:.6f}")
            for r, s in curve.items())
            + f" ({'equal to' if same else 'DIFFERS FROM'} BENCH_dcn.json)")
        if not same:
            raise AssertionError(f"fig17c: the {variant} curve differs from BENCH_dcn.json")
    return {"launches": launches, "seconds": dt, "numpy_seconds": dt_np, "rows": rows,
            "run": lambda: run_dcn_sweep(spec, backend="torch", masks=masks, device=device)}


def dc_spec():
    from repro_torch.dcn import DcnSpec

    return DcnSpec(num_nodes=DC_NODES, agg_domain=512, fault_ratios=DCN_RATIOS,
                   samples=DC_SAMPLES, tp_sizes=DC_TPS, job_scale=0.85, seed=3,
                   variants=("orchestrated",))


def placement_digest(bp):
    """sha256 of a placement's members, feasible and n_constraints (their
    shapes and int64 values), which equal digests hold equal."""
    h = hashlib.sha256()
    for a in (bp.members, bp.feasible, bp.n_constraints):
        a = np.asarray(a)
        h.update(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a, dtype=np.int64).tobytes())
    return h.hexdigest()


def dc_refs():
    """numpy's placements of dcn_datacenter's rows, ~2.5 ms a row on the
    host: {tp: ([digest of each ratio's rows], seconds)}."""
    from repro_torch.dcn import batched_fat_tree

    spec = dc_spec()
    masks = [spec.masks(ri) for ri in range(len(DCN_RATIOS))]
    out = {}
    for tp in DC_TPS:
        t0 = time.perf_counter()
        out[tp] = ([placement_digest(batched_fat_tree(mk, spec.config, tp, spec.job_gpus(tp)))
                    for mk in masks], time.perf_counter() - t0)
    return out


def dcn_datacenter(torch, refs=None):
    """8192 nodes (32,768 GPUs), 512-node domains, the five ratios x 1024
    snapshots, TP 32 and 64, orchestrated only; masks drawn before the
    timer.  The main path (``run_dcn_sweep``) with its launch count, the
    placement kernel timed alone per TP and held to numpy on every row (by
    digest when ``refs``, a Background of host_refs, computed numpy's
    beside the earlier phases), a profile of one TP's blocks, and two
    plants caught."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dcn import batched_fat_tree, run_dcn_sweep
    from repro_torch.dcn.torch_backend import fat_tree_placements, scans_per_call, search_iters
    from repro_torch.kernels.prefix_scan import prefix_scan

    spec = dc_spec()
    cfg = spec.config
    masks = [spec.masks(ri) for ri in range(len(DCN_RATIOS))]
    stacked = np.concatenate(masks)
    rows = stacked.shape[0]
    chunks = -(-rows // DC_CHUNK)
    jobs = [spec.job_gpus(tp) for tp in DC_TPS]
    per_call = {tp: scans_per_call(cfg, tp) for tp in DC_TPS}
    iters = search_iters(cfg)

    # the main path: run_dcn_sweep on the card, launches counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefix_scan.launches = 0
    t0 = time.perf_counter()
    res = run_dcn_sweep(spec, backend="torch", masks=masks, chunk_snapshots=DC_CHUNK)
    wall = time.perf_counter() - t0
    launches = prefix_scan.launches
    peak = torch.cuda.max_memory_allocated()
    want = sum(per_call.values()) * chunks
    if any(v != 4 * (iters + 1) + 2 for v in per_call.values()) or launches != want:
        raise AssertionError(f"dc: prefix_scan launched {launches} times; want "
                             f"4 * ({iters} + 1) + 2 per (block, TP) x {chunks} blocks x "
                             f"{len(DC_TPS)} TPs = {want}")
    print(f"dc: {rows} snapshots x {DC_NODES} nodes ({4 * DC_NODES} GPUs), agg 512, TP "
          f"{'/'.join(map(str, DC_TPS))}, orchestrated: run_dcn_sweep on the card {wall:.3f} s "
          f"({rows / wall:.0f} rows/s at both TPs), peak device memory {peak / 1e9:.2f} GB; "
          f"prefix_scan launches {launches} = {launches // (chunks * len(DC_TPS))} per "
          f"(block, TP) = 4 * (iters {iters} + 1) + 2, x {chunks} blocks x {len(DC_TPS)} TPs")

    # the placement kernel alone, per TP, beside numpy on every row (numpy
    # takes ~2.5 ms a row on the host; one ratio's rows a call)
    out = {"launches": launches, "rows": rows, "peak_gb": peak / 1e9,
           "sweep_rows_per_s": rows / wall, "per_tp": {}}
    scans_bytes = 0
    want = refs.get("dc") if refs else None
    where = " in a process of its own" if refs else ""
    for tp, job in zip(DC_TPS, jobs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bp = fat_tree_placements(stacked, cfg, [tp], [job], chunk_snapshots=DC_CHUNK)[0]
        dt = time.perf_counter() - t1
        dt_np = want[tp][1] if want else 0.0
        for ri, mk in enumerate(masks):
            rows_ri = slice(ri * DC_SAMPLES, (ri + 1) * DC_SAMPLES)
            got = type(bp)(bp.members[rows_ri], bp.feasible[rows_ri],
                           bp.n_constraints[rows_ri], bp.need, bp.m)
            if want:
                same = placement_digest(got) == want[tp][0][ri]
            else:
                t2 = time.perf_counter()
                ref = batched_fat_tree(mk, cfg, tp, job)
                dt_np += time.perf_counter() - t2
                same = placements_equal(got, ref)
                del ref
            if not same:
                raise AssertionError(f"dc: TP-{tp} placements differ from numpy at "
                                     f"{DCN_RATIOS[ri]:.0%} faults")
            del got
        ti = DC_TPS.index(tp)
        if not (np.array_equal(res.feasible[0, :, :, ti].reshape(-1), bp.feasible)
                and np.array_equal(res.n_constraints[:, :, ti].reshape(-1), bp.n_constraints)):
            raise AssertionError(f"dc: TP-{tp} run_dcn_sweep and the kernel alone disagree")
        # each scan reads its bool input once and writes int32 once; every
        # scan of this path runs over rows x num_nodes elements
        scan_bytes = per_call[tp] * rows * DC_NODES * (1 + 4)
        scans_bytes += scan_bytes
        feas = bp.feasible.reshape(len(DCN_RATIOS), DC_SAMPLES).mean(axis=1)
        print(f"dc: TP-{tp}: placement kernel {dt:.3f} s = {rows / dt:.0f} rows/s on the card; "
              f"numpy {rows / dt_np:.0f} rows/s on the host ({dt_np:.2f} s{where}; every row "
              f"equal to the card's); "
              f"feasible share by ratio " + "/".join(f"{f:.3f}" for f in feas)
              + f"; scans' bytes bound {scan_bytes / 1e9:.3f} GB = "
              f"{scan_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
        out["per_tp"][tp] = {"rows_per_s": rows / dt, "numpy_rows_per_s": rows / dt_np,
                             "scan_bound_ms": scan_bytes / HBM_BYTES_PER_S * 1e3}
        if tp == DC_TPS[0]:
            plant_input, plant_output = stacked[:1].copy(), bp
    out["scan_bound_ms"] = scans_bytes / HBM_BYTES_PER_S * 1e3

    # plants: a fault on a placed node of the fault-free row, and one member
    # of the card's output changed, must both fail the comparison
    tp, job = DC_TPS[0], jobs[0]
    node = int(plant_output.members[0, 0, 0])
    plant_input[0, node] = True
    planted = fat_tree_placements(plant_input, cfg, [tp], [job])[0]
    ref0 = batched_fat_tree(stacked[:1], cfg, tp, job)
    corrupt = type(plant_output)(plant_output.members[:1].copy(), plant_output.feasible[:1],
                                 plant_output.n_constraints[:1], plant_output.need,
                                 plant_output.m)
    corrupt.members[0, 0, 0] += 1
    caught = (not placements_equal(planted, ref0), not placements_equal(corrupt, ref0))
    print(f"dc plant: a fault on node {node} of the card's input "
          f"{'caught' if caught[0] else 'MISSED'}; one member of the card's output changed "
          f"{'caught' if caught[1] else 'MISSED'}")
    if not all(caught):
        raise AssertionError("dc: a planted fault passed the comparison")

    # where the time goes: one TP's blocks under the profiler
    fat_tree_placements(stacked[:DC_CHUNK], cfg, [tp], [job], chunk_snapshots=DC_CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        fat_tree_placements(stacked, cfg, [tp], [job], chunk_snapshots=DC_CHUNK)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t3) * 1e3
    summary = summarize_profile(torch, prof, prof_ms, 1,
                                f"TP-{tp} placement of {rows} rows x {DC_NODES} nodes",
                                {"prefix scan": "prefix_scan_", "cummax/cummin":
                                 "with_indices", "sorts": "ort"})
    if summary:
        scan_ms = summary["groups"]["prefix scan"]
        print(f"dc profile: device busy {summary['busy_ms']:.1f} of {prof_ms:.1f} ms "
              f"({summary['idle_pct']:.1f}% idle); prefix scans {scan_ms:.2f} ms = "
              f"{100 * scan_ms / summary['busy_ms']:.1f}% of device time against their "
              f"bytes bound {per_call[tp] * rows * DC_NODES * 5 / HBM_BYTES_PER_S * 1e3:.3f} ms")
        out.update(profile=summary, profile_wall_ms=prof_ms)
    return out


def time_short_row_scans(torch, rows=DC_CHUNK):
    """The placement's scans at 8192 nodes (time_scan_shape): the tier
    carve's rows x 16 domains x 8 sub-lines of 64 ToR positions (512-node
    domains) and the residual carve's rows of 8192."""
    return {label: time_scan_shape(torch, label, shape, seed=24)
            for label, shape in (("tier", (rows, 16, 8, 64)), ("residual", (rows, DC_NODES)))}


TRAFFIC_KW = dict(tp_sizes=(32,), agg_domain=512)


def traffic_ref():
    """numpy's ``traffic_replay`` of churn_on_card's 348-day trace:
    (timeline, seconds)."""
    from repro_torch.churn import ChurnSpec, traffic_replay

    trace = ChurnSpec(trace_nodes=1024).trace(0)
    t0 = time.perf_counter()
    tl = traffic_replay(trace, backend="numpy", **TRAFFIC_KW)
    return tl, time.perf_counter() - t0


def churn_on_card(torch, refs=None):
    """benchmarks/churn.py's acceptance ensemble (256 traces of 200 8-GPU
    nodes, 60 days, TP-32, InfiniteHBD-K3, NVL-72, TPUv4) batched and
    streamed on the card, equal to numpy; one 348-day trace of 1024 8-GPU
    nodes (2048 4-GPU nodes, 512-node domains) through ``traffic_replay``,
    equal to numpy (``refs``: a Background of host_refs, which replayed it
    beside the earlier phases); one control-plane replay on the host."""
    from repro_torch.churn import (ChurnJob, ChurnSpec, control_plane_replay,
                                   latency_table, monte_carlo_replay, traffic_replay)
    from repro_torch.dcn.engine import VARIANTS, evaluate_placements
    from repro_torch.dcn.torch_backend import scans_per_call
    from repro_torch.dcn.kernel import FatTreeConfig
    from repro_torch.kernels.prefix_scan import prefix_scan
    from repro_torch.sim.torch_backend import infinitehbd_scans

    spec = ChurnSpec(trace_nodes=200, horizon_h=60 * 24.0, tp_sizes=(32,),
                     architectures=("infinitehbd-k3", "nvl-72", "tpuv4"), seed=1)
    n_traces = 256
    t0 = time.perf_counter()
    traces = [spec.trace(r) for r in range(n_traces)]
    gen_s = time.perf_counter() - t0
    intervals = sum(len(tr.interval_edges()) for tr in traces)
    recorded = json.loads((ROOT / "BENCH_churn.json").read_text())["intervals_total"]
    if intervals != recorded:
        raise AssertionError(f"churn: {intervals} intervals, BENCH_churn.json has {recorded}")
    t1 = time.perf_counter()
    ref = monte_carlo_replay(spec, traces, backend="numpy")
    np_s = time.perf_counter() - t1
    out = {"traces": n_traces, "intervals": intervals, "numpy_traces_per_s": n_traces / np_s}
    scans = sum(infinitehbd_scans(m) for m in spec.models() if m.name.startswith("infinitehbd"))
    for engine in ("batched", "streamed"):
        torch.cuda.synchronize()
        prefix_scan.launches = 0
        t2 = time.perf_counter()
        got = monte_carlo_replay(spec, traces, engine=engine, backend="torch")
        dt = time.perf_counter() - t2
        launches = prefix_scan.launches
        same = got.backend == "torch" and all(
            np.array_equal(a.placed_gpus, b.placed_gpus)
            and np.array_equal(a.faulty_gpus, b.faulty_gpus)
            and np.array_equal(a.total_gpus, b.total_gpus)
            for a, b in zip(got.timelines, ref.timelines))
        want = scans * -(-intervals // 4096) if engine == "batched" else None
        print(f"churn {engine}: {n_traces} traces, {intervals} intervals x {spec.num_nodes} "
              f"nodes: torch {dt:.3f} s = {n_traces / dt:.1f} traces/s, numpy "
              f"{n_traces / np_s:.1f} traces/s (traces generated in {gen_s:.2f} s, not timed); "
              f"timelines {'equal' if same else 'DIFFER'}; prefix_scan launches {launches}")
        if not same:
            raise AssertionError(f"churn {engine}: torch timelines differ from numpy")
        if launches == 0 or (want is not None and launches != want):
            raise AssertionError(f"churn {engine}: prefix_scan launched {launches} times"
                                 + ("" if want is None else f", want {want}"))
        out[engine] = {"traces_per_s": n_traces / dt, "launches": launches, "seconds": dt}
    summary = {r["architecture"]: r for r in got.summary_table()}
    print("churn: mean time-integrated waste at TP-32 " + ", ".join(
        f"{n} {100 * r['mean_waste']:.3f}% (P99 {100 * r['p99_waste']:.3f}%)"
        for n, r in summary.items()))

    trace = ChurnSpec(trace_nodes=1024).trace(0)
    edges = len(trace.interval_edges())
    kw = TRAFFIC_KW
    cfg = FatTreeConfig(trace.num_nodes, 4, 8, 512, 3)
    torch.cuda.synchronize()
    prefix_scan.launches = 0
    t3 = time.perf_counter()
    tl = traffic_replay(trace, backend="torch", **kw)
    dt = time.perf_counter() - t3
    launches = prefix_scan.launches
    tl_np, dt_np = refs.get("traffic") if refs else traffic_ref()
    where = " in a process of its own" if refs else ""
    fields = ("groups", "dp_pairs", "crossing_pairs", "crossing_pod_pairs", "feasible")
    same = tl.backend == "torch" and all(
        np.array_equal(getattr(tl, f), getattr(tl_np, f)) for f in fields)
    want = scans_per_call(cfg, 32) * -(-edges // 4096)
    print(f"traffic replay: one 348-day trace of {trace.num_nodes} nodes, {edges} intervals, "
          f"agg 512, TP-32, {len(VARIANTS)} variants: torch {dt:.3f} s = {edges / dt:.0f} "
          f"rows/s, numpy {dt_np:.3f} s{where} = {edges / dt_np:.0f} rows/s; grids "
          f"{'equal' if same else 'DIFFER'}; prefix_scan launches {launches} (want {want})")
    if not same or launches != want:
        raise AssertionError("traffic replay: torch grids differ from numpy or the scan "
                             "launches are off")
    feas = tl.feasible_time_share()[:, 0]
    cross = tl.time_mean_shares()["cross_tor_share"][:, 0]
    print("traffic replay: time-mean cross-ToR share (1:9 bytes) " + ", ".join(
        f"{v} {cross[i]:.5f} (placeable {100 * feas[i]:.2f}% of the time)"
        for i, v in enumerate(tl.variants)))
    # the replay's device part alone: the orchestrated placement of every
    # interval (the masks, the baselines and the pair counts are host code)
    masks = trace.fault_masks(trace.interval_edges())
    job = max(int(trace.num_nodes * 4 * 0.85) // 32 * 32, 32)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    evaluate_placements(masks, cfg, "orchestrated", 32, job, backend="torch",
                        chunk_snapshots=4096)
    dt_o = time.perf_counter() - t6
    print(f"traffic replay: the orchestrated placement alone {dt_o:.3f} s = "
          f"{edges / dt_o:.0f} rows/s on the card; the rest of the torch replay's "
          f"{dt:.3f} s is host code (interval masks, the greedy and DGX-island "
          f"baselines, pair counts)")
    out["traffic"] = {"intervals": edges, "rows_per_s": edges / dt,
                      "numpy_rows_per_s": edges / dt_np, "launches": launches,
                      "orchestrated_rows_per_s": edges / dt_o}

    job = ChurnJob(tp_size=32, dp_size=8, agg_domain=80)
    t5 = time.perf_counter()
    recs = control_plane_replay(traces[0], job, max_events=100)
    dt = time.perf_counter() - t5
    row = latency_table({"400 nodes": recs})[0]
    print(f"control plane: {row['reconfigs']} reconfigurations of trace 0 on the host in "
          f"{dt:.2f} s ({row['infeasible']} infeasible): latency mean {row['mean_us']:.1f} us, "
          f"P50 {row['p50_us']:.1f}, P90 {row['p90_us']:.1f}, P99 {row['p99_us']:.1f}, "
          f"max {row['max_us']:.1f}")
    out["control_plane"] = row
    return out


# ------------------------------------------------------------ cost, matrix, SLO and faults slice


COST_SEED = 5                                     # benchmarks/cost.py's spec
BIG_NODES = 8192                                  # 32,768 GPUs
FAULT_ARCHES = ("big-switch", "infinitehbd-k3", "nvl-72", "acos")   # benchmarks/faults.py
FAULT_TPS = (16, 32)
SERVE_ARCHES = ("big-switch", "infinitehbd-k2", "infinitehbd-k3", "nvl-72", "tpuv4",
                "sip-ring")                       # benchmarks/serve.py
SERVE_GRIDS = ("served", "served_cum", "gone_cum", "queue_depth")
# sha256 of masks(96) at samples=128, seed=7 (tests/test_prng_digests.py)
GENERATOR_PINS = {
    "CorrelatedTorOutages": "1b5d6d7492f36251b5b74fc5c28314923c1315712bef9397aad0ce50ce6fc8f1",
    "MaintenanceWindows": "9132aeddd11588340bd237006d72476862d2394563e6e74da38db2769c88b559",
    "BurstStorms": "1f2b1b812691d3c4d608118b12c1c90a7595ecf8553be482a51893416f39ee68",
    "FlappingStragglers": "02d35517fedde8056c774457b9a418645b17d589e7f81b06b24187adca339834",
}


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_share(torch, device, label, fn):
    """Run ``fn`` once more under torch.profiler (CUDA kernels only) and
    print the card's busy time against the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        return None
    sync(torch, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = _busy_ms(torch, prof)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    idle = 100 * (1 - busy / wall_ms)
    print(f"profile {label}: {wall_ms:.1f} ms wall under the profiler, card busy {busy:.1f} ms "
          f"({idle:.1f}% idle), {sum(1 for _ in by_name)} distinct device events; the most: "
          + "; ".join(f"{name[:60]} {t / 1e3:.1f} ms" for name, t in top))
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_pct": idle,
            "top_ms": {name[:60]: t / 1e3 for name, t in top}}


def sweep_scans(models, blocks):
    """prefix_scan launches of a torch sweep: each InfiniteHBD model's
    kernel call scans once or twice a block (``infinitehbd_scans``)."""
    from repro_torch.core.hbd_models import InfiniteHBDModel
    from repro_torch.sim.torch_backend import infinitehbd_scans

    return blocks * sum(infinitehbd_scans(m) for m in models if isinstance(m, InfiniteHBDModel))


def fig17d_musd(result):
    """benchmarks/cost.py's Fig. 17d record: per TP, the mean aggregate cost
    in MUSD at 3 decimals of each architecture that hosts the TP."""
    from repro_torch.cost import cost_effectiveness_table, hosting_architectures

    out = {}
    for tp in (32, 8):
        hosts = hosting_architectures(result, tp)
        by_ratio = {}
        for r in cost_effectiveness_table(result, baseline="nvl-72", tp=tp):
            if r["architecture"] in hosts:
                by_ratio.setdefault(f"{r['fault_ratio']:.2f}", {})[r["architecture"]] = \
                    round(r["mean_cost_usd"] / 1e6, 3)
        out[f"fig17d_musd_tp{tp}"] = by_ratio
        out[f"fig17d_tp{tp}_skipped"] = [n for n in result.names if n not in hosts]
    return out


def cost_grids_equal(a, b):
    return a.names == b.names and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("total_gpus", "faulty_gpus", "placed_gpus", "cost_usd"))


def cost_spec(nodes, samples):
    from repro_torch.cost import CostSpec

    recorded = json.loads((ROOT / "BENCH_cost.json").read_text())
    return CostSpec(num_nodes=nodes, fault_ratios=tuple(recorded["fault_ratios"]),
                    samples=samples, tp_sizes=tuple(recorded["tp_sizes"]), seed=COST_SEED,
                    architectures=tuple(recorded["architectures"]))


def cost_ref():
    """numpy's cost grids at 8192 nodes x 1024 snapshots a ratio: (grids,
    seconds)."""
    from repro_torch.cost import run_cost_sweep

    t0 = time.perf_counter()
    return run_cost_sweep(cost_spec(BIG_NODES, 1024), backend="numpy"), time.perf_counter() - t0


def cost_on_card(torch, device="cuda", refs=None):
    """benchmarks/cost.py's spec (768 nodes, 6 ratios x 200 snapshots, TP 8
    and 32, seed 5, 7 architectures) through ``run_cost_sweep`` on the
    card: grids equal to numpy, Fig. 17d, Table 6 and the headline ratios
    equal to BENCH_cost.json; then 8192 nodes x 1024 snapshots a ratio,
    equal to numpy (``refs``: a Background of host_refs, which computed
    numpy's), rows/s for each backend and the card's busy share."""
    from repro_torch.cost import headline_ratio_rows, per_gpu_cost_table, run_cost_sweep
    from repro_torch.kernels.prefix_scan import prefix_scan

    recorded = json.loads((ROOT / "BENCH_cost.json").read_text())
    table6 = {r["architecture"]: r["per_gpu_cost"] for r in per_gpu_cost_table()}
    if table6 != recorded["table6_per_gpu_usd"] \
            or headline_ratio_rows() != recorded["headline_ratios"]:
        raise AssertionError("cost: Table 6 or the headline ratios differ from BENCH_cost.json")
    out = {}
    for label, nodes, samples in (("bench", recorded["num_nodes"], recorded["samples"]),
                                  ("8192", BIG_NODES, 1024)):
        spec = cost_spec(nodes, samples)
        rows = len(spec.fault_ratios) * samples
        if refs and label == "8192":
            ref, np_s = refs.get("cost")
        else:
            t0 = time.perf_counter()
            ref = run_cost_sweep(spec, backend="numpy")
            np_s = time.perf_counter() - t0
        want = sweep_scans(spec.models(), len(spec.fault_ratios) * -(-samples // 1024))
        times = []
        for _ in range(2 if label == "bench" else 1):   # the first call loads the modules
            sync(torch, device)
            prefix_scan.launches = 0
            t1 = time.perf_counter()
            got = run_cost_sweep(spec, backend="torch", device=device)
            sync(torch, device)
            times.append(time.perf_counter() - t1)
            launches = prefix_scan.launches
        if got.backend != "torch" or not cost_grids_equal(got, ref):
            raise AssertionError(f"cost {label}: torch grids differ from numpy")
        if launches != want:
            raise AssertionError(f"cost {label}: prefix_scan launched {launches} times, "
                                 f"want {want}")
        dt = times[-1]
        print(f"cost {label}: {rows} rows ({len(spec.fault_ratios)} ratios x {samples}) x "
              f"{nodes} nodes x {len(spec.architectures)} architectures x TP "
              f"{'/'.join(map(str, spec.tp_sizes))}: torch {dt:.3f} s = {rows / dt:.0f} rows/s"
              + (f" (first call {times[0]:.3f} s)" if len(times) > 1 else "")
              + f", numpy {np_s:.3f} s = {rows / np_s:.0f} rows/s; grids equal; prefix_scan "
              f"launches {launches}")
        out[label] = {"rows": rows, "rows_per_s": rows / dt, "numpy_rows_per_s": rows / np_s,
                      "launches": launches, "spec": spec, "result": got}
        if label == "bench":
            fig = fig17d_musd(got)
            same = all(fig[k] == recorded[k] for k in fig)
            print("cost bench: Fig. 17d MUSD at TP-32, "
                  + ", ".join(f"{r}: " + "/".join(f"{v:.3f}" for v in row.values())
                              for r, row in fig["fig17d_musd_tp32"].items())
                  + f" ({'equal to' if same else 'DIFFERS FROM'} BENCH_cost.json, TP-8 too); "
                  f"Table 6 and the headline ratios equal")
            if not same:
                raise AssertionError("cost: Fig. 17d differs from BENCH_cost.json")
        else:
            out[label]["profile"] = device_share(
                torch, device, f"cost sweep at {nodes} nodes",
                lambda: run_cost_sweep(spec, backend="torch", device=device))
    return out


def matrix_rows_rounded(rows):
    """benchmarks/matrix.py's record: the float columns at 6 decimals."""
    def r6(v):
        return None if v is None else round(v, 6)
    return [{**r, "waste_ratio": r6(r["waste_ratio"]), "mean_mfu": r6(r["mean_mfu"]),
             "cross_tor_share": r6(r["cross_tor_share"]),
             "usd_per_mfu_gpu_h": r6(r["usd_per_mfu_gpu_h"])} for r in rows]


def matrix_kw(samples):
    recorded = json.loads((ROOT / "BENCH_matrix.json").read_text())
    return dict(fault_ratios=tuple(recorded["fault_ratios"]), samples=samples,
                tp=recorded["tp_size"], architectures=tuple(recorded["architectures"]))


def matrix_ref():
    """numpy's comparison matrix at 8192 nodes x 256 snapshots a ratio:
    (rows, seconds)."""
    from repro_torch.sim import comparison_matrix

    t0 = time.perf_counter()
    return comparison_matrix(BIG_NODES, backend="numpy", **matrix_kw(256)), \
        time.perf_counter() - t0


def matrix_on_card(torch, device="cuda", refs=None):
    """benchmarks/matrix.py's comparison matrix (512 nodes, 4 ratios x 25
    snapshots, TP-32, 12 architectures) with both sweeps on the card: rows
    equal to numpy's and to BENCH_matrix.json at 6 decimals; then 8192
    nodes x 4 ratios x 256 snapshots, equal to numpy (``refs``: a
    Background of host_refs, which computed numpy's), with the time of each
    span and the card's busy share."""
    from repro_torch import obs
    from repro_torch.dcn import DcnSpec
    from repro_torch.dcn.torch_backend import scans_per_call
    from repro_torch.kernels.prefix_scan import prefix_scan
    from repro_torch.sim import comparison_matrix, make_model

    recorded = json.loads((ROOT / "BENCH_matrix.json").read_text())
    ratios, tp = tuple(recorded["fault_ratios"]), recorded["tp_size"]
    arches = tuple(recorded["architectures"])
    out = {}
    for label, nodes, samples in (("bench", recorded["num_nodes"], recorded["samples"]),
                                  ("8192", BIG_NODES, 256)):
        kw = matrix_kw(samples)
        cfg = DcnSpec(num_nodes=nodes).config
        rows_n = len(ratios) * samples
        want = sweep_scans([make_model(a, nodes) for a in arches],
                           len(ratios) * -(-samples // 1024)) \
            + (scans_per_call(cfg, tp) * -(-rows_n // 1024) if cfg.regular() else 0)
        if refs and label == "8192":
            ref, np_s = refs.get("matrix")
        else:
            t0 = time.perf_counter()
            ref = comparison_matrix(nodes, backend="numpy", **kw)
            np_s = time.perf_counter() - t0
        was = obs.enabled()
        obs.enable()
        obs.reset()
        sync(torch, device)
        prefix_scan.launches = 0
        t1 = time.perf_counter()
        got = comparison_matrix(nodes, backend="torch", device=device, **kw)
        sync(torch, device)
        dt = time.perf_counter() - t1
        launches = prefix_scan.launches
        spans = {k: v["total_s"] for k, v in obs.summary()["spans"].items()
                 if k.startswith("matrix.")}
        obs.reset()
        if not was:
            obs.disable()
        if got != ref:
            raise AssertionError(f"matrix {label}: torch rows differ from numpy")
        if launches != want:
            raise AssertionError(f"matrix {label}: prefix_scan launched {launches} times, "
                                 f"want {want}")
        print(f"matrix {label}: {len(got)} rows ({len(arches)} architectures x {len(ratios)} "
              f"ratios), {nodes} nodes x {samples} snapshots, TP-{tp}: torch {dt:.3f} s ("
              + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
              + f"), numpy {np_s:.3f} s; rows equal; prefix_scan launches {launches}")
        out[label] = {"rows": len(got), "seconds": dt, "numpy_seconds": np_s, "spans_s": spans,
                      "launches": launches}
        if label == "bench":
            same = matrix_rows_rounded(got) == recorded["rows"]
            print(f"matrix bench: the 48 rows at 6 decimals "
                  f"{'equal' if same else 'DIFFER FROM'} BENCH_matrix.json; tpuv4 at 10% "
                  + str({k: got[i][k] for i in range(len(got))
                         if got[i]["architecture"] == "tpuv4" and got[i]["fault_ratio"] == 0.1
                         for k in ("waste_ratio", "usd_per_mfu_gpu_h")}))
            if not same:
                raise AssertionError("matrix: rows differ from BENCH_matrix.json")
        else:
            out[label]["profile"] = device_share(
                torch, device, f"comparison matrix at {nodes} nodes",
                lambda: comparison_matrix(nodes, backend="torch", device=device, **kw))
    return out


def serve_spec_bench(device="cuda"):
    """benchmarks/serve.py's full spec: one 200-node (400 4-GPU nodes),
    60-day Appendix-A trace replayed with its control plane at TP-16;
    returns the churn spec and the serving spec."""
    from repro_torch.churn import ChurnJob, ChurnSpec, replay_trace
    from repro_torch.slo import DiurnalArrivals, PoissonArrivals, ServeSpec

    cspec = ChurnSpec(trace_nodes=200, horizon_h=60 * 24.0, tp_sizes=(16,),
                      architectures=SERVE_ARCHES, seed=1)
    tl = replay_trace(cspec.trace(0), tp_sizes=cspec.tp_sizes, architectures=SERVE_ARCHES,
                      job=ChurnJob(tp_size=16), device=device)
    return cspec, ServeSpec(timeline=tl,
                            arrivals=(PoissonArrivals(40.0, seed=2, stream=0),
                                      PoissonArrivals(80.0, seed=2, stream=1),
                                      DiurnalArrivals(60.0, seed=2, stream=2, amplitude=0.5)),
                            tp=16, req_per_gpu_hour=0.05, slo_h=2.0, patience_h=12.0)


def scan_drivers(res):
    """The serving scan's host drivers of a sweep result."""
    from repro_torch.slo import cohort_deadlines, expire_cumulative

    ca = np.cumsum(res.arrivals, axis=1)
    dead = cohort_deadlines(res.edges_h, res.horizon_h, res.patience_h)
    return ca, res.capacity, expire_cumulative(ca, dead)


def time_scans(torch, device, res, label):
    """The serving scan alone, torch (second call) against _scan_numpy on the
    drivers of ``res`` (a torch sweep, whose grids must equal numpy's):
    requests/s as benchmarks/serve.py counts them (each request through
    every architecture's queue)."""
    from repro_torch.slo import torch_backend
    from repro_torch.slo.engine import _scan_numpy

    drivers = scan_drivers(res)
    t0 = time.perf_counter()
    want = _scan_numpy(*drivers)
    np_s = time.perf_counter() - t0
    torch_backend.serve_scan(*drivers, device=device)
    t1 = time.perf_counter()
    got = torch_backend.serve_scan(*drivers, device=device)
    dt = time.perf_counter() - t1
    if not all(np.array_equal(g, w) and np.array_equal(getattr(res, f), w)
               for f, g, w in zip(SERVE_GRIDS, got, want)):
        raise AssertionError(f"slo {label}: the torch scan differs from _scan_numpy")
    R, A, B = got[0].shape
    requests = int(res.total_arrivals.sum()) * A
    passes = math.ceil(math.log2(B)) if B > 1 else 0
    print(f"slo {label}: serve scan {R} streams x {A} architectures x {B} intervals "
          f"({passes} doubling passes): torch {dt * 1e3:.2f} ms = {requests / dt:.4g} requests/s, "
          f"_scan_numpy {np_s * 1e3:.2f} ms = {requests / np_s:.4g} requests/s "
          f"({np_s / dt:.1f}x); grids equal")
    return drivers, {"intervals": B, "passes": passes, "torch_s": dt, "numpy_s": np_s,
                     "requests_per_s": requests / dt, "numpy_requests_per_s": requests / np_s}


def slo_replay(device="cuda"):
    """serve_spec_bench's replay (its control plane is host code): (churn
    spec, serving spec, seconds, prefix_scan launches and their histogram)."""
    import torch

    from repro_torch.kernels.prefix_scan import prefix_scan

    sync(torch, device)
    prefix_scan.launches = 0
    t0 = time.perf_counter()
    with ScanHistogram() as hist:
        cspec, spec = serve_spec_bench(device)
    return cspec, spec, time.perf_counter() - t0, prefix_scan.launches, hist.counts


def slo_replay_to(path):
    """slo_replay on the card, pickled to ``path``; returns its seconds."""
    out = slo_replay()
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    return out[2]


def slo_on_card(torch, device="cuda", replay=None):
    """benchmarks/serve.py's spec on the card (the replay's sweep and the
    serving scan): grids equal to numpy and to the scalar reference,
    261,209 requests, slo_table equal to BENCH_serve.json; then PR 24's
    348-day trace of 2048 nodes (37,791 intervals) with 64 streams near the
    fleet's fault-free capacity, grids equal to numpy, requests/s.
    ``replay``: slo_replay's result, from a process of its own."""
    from repro_torch.churn import ChurnSpec, replay_trace
    from repro_torch.slo import (DiurnalArrivals, PoissonArrivals, ServeSpec, run_serve_scalar,
                                 run_serve_sweep, slo_table, torch_backend)

    recorded = json.loads((ROOT / "BENCH_serve.json").read_text())
    cspec, spec, replay_s, replay_launches, _ = replay or slo_replay(device)
    tl = spec.timeline
    # the replay's sweep: the InfiniteHBD models' scans, once a 4096-interval block
    want = sweep_scans(cspec.models(), -(-tl.num_intervals // 4096))
    if replay_launches != want or tl.num_intervals != recorded["intervals"]:
        raise AssertionError(f"slo: the replay launched prefix_scan {replay_launches} times "
                             f"(want {want}) over {tl.num_intervals} intervals")
    got = run_serve_sweep(spec, backend="torch", device=device)
    ref = run_serve_sweep(spec, backend="numpy")
    scalar = run_serve_scalar(spec)
    same = all(np.array_equal(getattr(got, f), getattr(o, f))
               for f in SERVE_GRIDS for o in (ref, scalar))
    requests = int(got.total_arrivals.sum())
    table_same = slo_table(got) == recorded["slo_table"]
    print(f"slo bench: {cspec.num_nodes} nodes, "
          f"{tl.num_intervals} intervals ({len(tl.reconfigs)} reconfigurations, the trace "
          f"replayed on the card with its control plane in {replay_s:.2f} s"
          f"{' in a process of its own' if replay else ''}, prefix_scan "
          f"launches {replay_launches}); {requests} requests: torch grids "
          f"{'equal' if same else 'DIFFER FROM'} numpy and the scalar reference; slo_table "
          f"{'equal to' if table_same else 'DIFFERS FROM'} BENCH_serve.json")
    if got.backend != "torch" or not same or requests != recorded["requests_total"] \
            or not table_same:
        raise AssertionError("slo bench: grids, requests or slo_table differ")
    out = {"replay_launches": replay_launches, "requests": requests,
           "bench": time_scans(torch, device, got, "bench")[1]}

    # PR 24's 348-day trace of 1024 8-GPU nodes (2048 4-GPU nodes); 64 streams
    # from half to all of the fleet's fault-free capacity at 0.01 requests a
    # GPU-hour (the host's Poisson inversion grows with the mean)
    trace = ChurnSpec(trace_nodes=1024).trace(0)
    t1 = time.perf_counter()
    tl = replay_trace(trace, tp_sizes=(16,), architectures=SERVE_ARCHES, device=device)
    replay_s = time.perf_counter() - t1
    rate = trace.num_nodes * 4 * 0.01
    arrivals = tuple(
        PoissonArrivals(rate * (0.5 + 0.5 * i / 63), seed=3, stream=i) if i % 2 == 0 else
        DiurnalArrivals(rate * (0.5 + 0.5 * i / 63), seed=3, stream=i, amplitude=0.5)
        for i in range(64))
    spec = ServeSpec(timeline=tl, arrivals=arrivals, tp=16, req_per_gpu_hour=0.01, slo_h=2.0,
                     patience_h=12.0)
    t2 = time.perf_counter()
    got = run_serve_sweep(spec, backend="torch", device=device)
    sweep_s = time.perf_counter() - t2
    drivers, big = time_scans(torch, device, got, "2048 nodes")
    big["profile"] = device_share(torch, device, "serve scan at 2048 nodes",
                                  lambda: torch_backend.serve_scan(*drivers, device=device))
    print(f"slo 2048 nodes: {tl.num_intervals} intervals replayed on the card in "
          f"{replay_s:.2f} s; {int(got.total_arrivals.sum())} requests in 64 streams; "
          f"run_serve_sweep {sweep_s:.2f} s on the host clock (arrivals and capacity on the "
          f"host, then the scan)")
    out["2048"] = big
    return out


def time_mean_waste(tl):
    """benchmarks/faults.py's duration-weighted stranded-GPU waste, (A, T)."""
    stranded = tl.total_gpus[:, None, :] - tl.faulty_gpus - tl.placed_gpus
    w = tl.durations_h / tl.horizon_h
    return np.einsum("abt,b->at", stranded / tl.total_gpus[:, None, :], w)


def fault_masks_on_card(torch, device, gens, nodes):
    """Each generator's ``torch_masks`` on the card equal to its NumPy masks
    at BENCH_faults.json's size, at the pinned digests and at 8192 nodes."""
    from repro_torch.faults import GENERATORS

    out = {}
    for cls, gen in zip(GENERATORS, gens):
        pinned = cls(samples=128, seed=7)
        digest = hashlib.sha256(np.ascontiguousarray(
            pinned.torch_masks(96, device=device).cpu().numpy()).tobytes()).hexdigest()
        if digest != GENERATOR_PINS[cls.__name__] \
                or not np.array_equal(gen.torch_masks(nodes, device=device).cpu().numpy(),
                                      gen.masks(nodes)):
            raise AssertionError(f"faults: {gen.label} torch_masks differ from numpy or its pin")
        t0 = time.perf_counter()
        want = gen.masks(BIG_NODES)
        np_s = time.perf_counter() - t0
        gen.torch_masks(BIG_NODES, device=device)
        sync(torch, device)
        t1 = time.perf_counter()
        got = gen.torch_masks(BIG_NODES, device=device)
        sync(torch, device)
        dt = time.perf_counter() - t1
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"faults: {gen.label} torch_masks differ at {BIG_NODES} nodes")
        cells = gen.samples * BIG_NODES
        print(f"faults {gen.label}: torch_masks equal numpy at {nodes} and {BIG_NODES} nodes x "
              f"{gen.samples} ticks and the pinned digest; at {BIG_NODES} nodes torch "
              f"{dt * 1e3:.2f} ms = {cells / dt:.4g} node-ticks/s, numpy {np_s * 1e3:.2f} ms = "
              f"{cells / np_s:.4g}; fault ratio {want.mean():.6f}")
        out[gen.label] = {"torch_ms": dt * 1e3, "numpy_ms": np_s * 1e3}
    out["profile"] = device_share(torch, device, f"the four generators at {BIG_NODES} nodes",
                                  lambda: [g.torch_masks(BIG_NODES, device=device) for g in gens])
    return out


def scenario_entry(device, gen, nodes):
    """One row of benchmarks/faults.py's scenario_table, every engine with a
    device path on the card and held to its numpy (and scalar) path."""
    from repro_torch.churn import replay_trace, traffic_replay
    from repro_torch.cost import timeline_cost_table
    from repro_torch.sim import ScenarioSpec, run_sweep, run_sweep_scalar
    from repro_torch.slo import (PoissonArrivals, ServeSpec, run_serve_scalar, run_serve_sweep,
                                 slo_table)

    spec = ScenarioSpec(num_nodes=nodes, snapshots=gen, tp_sizes=FAULT_TPS,
                        architectures=FAULT_ARCHES)
    sweep = run_sweep(spec, backend="torch", device=device)
    ref = run_sweep_scalar(spec)
    if not (np.array_equal(sweep.placed_gpus, ref.placed_gpus)
            and np.array_equal(sweep.faulty_gpus, ref.faulty_gpus)):
        raise AssertionError(f"faults {gen.label}: the torch sweep differs from the scalar loop")
    trace = gen.trace(nodes)
    kw = dict(tp_sizes=FAULT_TPS, architectures=FAULT_ARCHES)
    tl = replay_trace(trace, backend="torch", device=device, **kw)
    tl_ref = replay_trace(trace, engine="scalar", **kw)
    if not all(np.array_equal(getattr(tl, f), getattr(tl_ref, f))
               for f in ("placed_gpus", "faulty_gpus", "edges_h")):
        raise AssertionError(f"faults {gen.label}: the torch replay differs from the scalar one")
    waste = time_mean_waste(tl)
    tt = traffic_replay(trace, tp_sizes=(32,), variants=("orchestrated",), backend="torch",
                        device=device)
    tt_ref = traffic_replay(trace, tp_sizes=(32,), variants=("orchestrated",), backend="numpy")
    if not all(np.array_equal(getattr(tt, f), getattr(tt_ref, f))
               for f in ("groups", "dp_pairs", "crossing_pairs", "crossing_pod_pairs")):
        raise AssertionError(f"faults {gen.label}: the torch traffic replay differs from numpy")
    inf_cost = next(r for r in timeline_cost_table(tl, tp=32)
                    if r["architecture"] == "infinitehbd-k3")
    serve = ServeSpec(timeline=tl, arrivals=(PoissonArrivals(8.0, seed=2, stream=0),), tp=16,
                      req_per_gpu_hour=0.05, slo_h=2.0, patience_h=12.0)
    res = run_serve_sweep(serve, backend="torch", device=device)
    res_ref = run_serve_scalar(serve)
    if not all(np.array_equal(getattr(res, f), getattr(res_ref, f)) for f in SERVE_GRIDS):
        raise AssertionError(f"faults {gen.label}: the torch serving scan differs from scalar")
    attain = next(r["slo_attainment"] for r in slo_table(res)
                  if r["architecture"] == "infinitehbd-k3")
    return {
        "scenario": gen.label,
        "fault_ratio": round(float(gen.masks(nodes).mean()), 6),
        "events": len(trace.events),
        "intervals": tl.num_intervals,
        "waste_tp32_big_switch": round(float(waste[FAULT_ARCHES.index("big-switch"), 1]), 6),
        "waste_tp32_infinitehbd": round(float(waste[FAULT_ARCHES.index("infinitehbd-k3"), 1]),
                                        6),
        "cross_tor_share_tp32": round(
            float(tt.time_mean_shares()["cross_tor_share"][0, 0]), 6),
        "cost_time_mean_musd_infinitehbd": round(inf_cost["time_mean_cost_usd"] / 1e6, 4),
        "slo_attainment_infinitehbd": round(attain, 6),
    }


def claim_breaks(device, tor_gen, nodes):
    """benchmarks/faults.py's structured-vs-i.i.d. comparison at a matched
    marginal fault ratio, the replays on the card."""
    from repro_torch.churn import replay_trace, traffic_replay
    from repro_torch.core.prng import counter_fault_masks
    from repro_torch.faults import masks_to_trace

    tor_masks = tor_gen.masks(nodes)
    ratio = float(tor_masks.mean())
    iid_masks = counter_fault_masks(nodes, ratio, tor_gen.samples, seed=1)
    traces = {"tor-outages": tor_gen.trace(nodes),
              "iid": masks_to_trace(iid_masks, tor_gen.tick_h)}
    out = {"matched_fault_ratio": round(ratio, 6),
           "iid_fault_ratio": round(float(iid_masks.mean()), 6)}
    bs, inf = FAULT_ARCHES.index("big-switch"), FAULT_ARCHES.index("infinitehbd-k3")
    ti = FAULT_TPS.index(32)
    waste = {}
    for label, trace in traces.items():
        tl = replay_trace(trace, tp_sizes=FAULT_TPS, architectures=FAULT_ARCHES,
                          backend="torch", device=device)
        waste[label] = time_mean_waste(tl)
        if label == "iid":
            out["iid_matches_ideal_isolation"] = bool(
                np.array_equal(tl.placed_gpus[inf], tl.placed_gpus[bs]))
        tt = traffic_replay(trace, tp_sizes=(32,), variants=("orchestrated",), backend="torch",
                            device=device)
        out[f"cross_tor_share_{label.replace('-', '_')}"] = round(
            float(tt.time_mean_shares()["cross_tor_share"][0, 0]), 6)
    w_ideal = float(waste["tor-outages"][bs, ti])
    w_inf = float(waste["tor-outages"][inf, ti])
    w_iid = float(waste["iid"][inf, ti])
    out.update(
        waste_tp32_ideal_tor_outages=round(w_ideal, 6),
        waste_tp32_infinitehbd_tor_outages=round(w_inf, 6),
        waste_tp32_infinitehbd_iid=round(w_iid, 6),
        isolation_survives_tor_outage=bool(w_inf <= w_ideal + 1e-12),
        excess_waste_vs_ideal_pct=round(
            100.0 * (w_inf - w_ideal) / w_ideal, 2) if w_ideal else None,
        waste_increase_vs_iid_pct=round(
            100.0 * (w_inf - w_iid) / w_iid, 2) if w_iid else None,
        traffic_claim_survives=bool(
            out["cross_tor_share_tor_outages"] <= out["cross_tor_share_iid"] + 1e-12))
    return out


def faults_on_card(torch, device="cuda"):
    """BENCH_faults.json's four generators (192 nodes, 336 ticks, seed 11):
    ``torch_masks`` on the card equal to numpy (and at the pins and 8192
    nodes), then its scenario_table and claim_breaks rebuilt through the
    port with the sweeps, ``replay_trace``, ``traffic_replay`` and the
    serving scan on the card, equal to the JSON at its rounding."""
    from repro_torch.faults import GENERATORS
    from repro_torch.kernels.prefix_scan import prefix_scan

    recorded = json.loads((ROOT / "BENCH_faults.json").read_text())
    nodes, samples = recorded["num_nodes"], recorded["samples"]
    gens = tuple(cls(samples=samples, seed=11) for cls in GENERATORS)
    out = {"masks": fault_masks_on_card(torch, device, gens, nodes)}
    sync(torch, device)
    prefix_scan.launches = 0
    t0 = time.perf_counter()
    table = [scenario_entry(device, gen, nodes) for gen in gens]
    breaks = claim_breaks(device, gens[0], nodes)
    sync(torch, device)
    dt = time.perf_counter() - t0
    launches = prefix_scan.launches
    for row, want in zip(table, recorded["scenario_table"]):
        print(f"faults {row['scenario']}: " + ", ".join(
            f"{k} {v}" for k, v in row.items() if k != "scenario")
            + f" ({'equal to' if row == want else 'DIFFERS FROM'} BENCH_faults.json)")
    same = table == recorded["scenario_table"] and breaks == recorded["claim_breaks"]
    print(f"faults claim_breaks: excess waste vs the ideal under ToR outages "
          f"{breaks['excess_waste_vs_ideal_pct']}%, isolation survives "
          f"{breaks['isolation_survives_tor_outage']}, traffic claim survives "
          f"{breaks['traffic_claim_survives']} "
          f"({'equal to' if breaks == recorded['claim_breaks'] else 'DIFFERS FROM'} "
          f"BENCH_faults.json); the rebuild took {dt:.2f} s with the scalar and numpy "
          f"references, prefix_scan launches {launches}")
    if not same or launches == 0:
        raise AssertionError("faults: the rebuilt tables differ from BENCH_faults.json or "
                             "prefix_scan never launched")
    out.update(launches=launches, seconds=dt)
    return out


# ------------------------------------------------------------ parallel slice (phases 39-41)

# The ranks of phases 39-40 share the one card: processes of one
# torch.distributed world over gloo, each on cuda:0 (NCCL takes one rank a
# card).  Gloo's point-to-point sends take host memory only, so the ring's
# and the binary exchange's CUDA payloads pass through pinned host buffers
# (repro_torch.parallel.mesh.Axis.stages); its all-reduce and all-to-all
# take CUDA tensors themselves.  Their times are those of ranks sharing one
# H100 through host memory, not of collectives on an HBD.
PAR_RANKS = 4
# phase 39's payloads: the size of phase 40's MoE output, (B·S, d)
PAR_PAYLOAD = (2048, 4096)
PAR_GPIPE = (8, 16, 4096)        # microbatches, rows a microbatch, width
# gloo's all-reduce adds 4 float32 terms in its own order
PAR_PSUM_TOL = 1e-5
# phase 40: Mixtral-8x7B at PAR_LAYERS layers (the depth cut for the script's
# time, the widths published), B = 1, S = 2048 a data shard
PAR_LAYERS = 1
PAR_SEQ = 2048
PAR_SEED = 0
# The sharded model against the unsharded one.  In float32 each tensor's
# error over its norm: the shards add their partial sums in another order
# (~3e-6 on the H100).  In bf16 the shards round their partial sums to bf16
# before the all-reduce adds them, so tokens whose top-2 experts nearly tie
# can route to another expert, and their rows and their share of each
# gradient then differ by O(1): bf16 is held to tests/test_kernels.py's
# 2e-2 on the step's scalars (the loss, the gradient norm, the loss after
# the AdamW step, and at mesh (2, 2) the data shards' mean loss and
# gradient norm), and its hidden states' error is printed.
PAR_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PAR_EP_CF = 16.0                 # tests/_sharded_checks.py: no assignment drops


def par_cfg(cf=None):
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("mixtral"), num_layers=PAR_LAYERS)
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def par_batches(cfg, device, seq):
    from repro_torch.train import synthetic_batch

    return [{k: torch_from(v, device) for k, v in synthetic_batch(cfg, i, 1, seq).items()}
            for i in range(2)]


def par_draw(torch, cfg, device, dtype):
    """Phase 40's weights, heads padded for PAR_RANKS (Mixtral's need none)."""
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator(device=device).manual_seed(PAR_SEED),
                       tp=PAR_RANKS, device=device, dtype=dtype)


def torch_from(a, device):
    import torch

    return torch.from_numpy(a).to(device)


def rel_errs(torch, got, want):
    """(error's norm over the reference's, max error over its largest
    entry), in float32."""
    g, w = got.float(), want.to(got.device).float()
    d = g - w
    return (float(d.norm() / w.norm().clamp_min(1e-30)),
            float(d.abs().max() / w.abs().max().clamp_min(1e-30)))


def ring_reference(torch, xs, n):
    """The ring all-reduce's result on the host in its order of adds: chunk
    c is ((x[c+1] + x[c+2]) + ...) + x[c-1], then + x[c]."""
    chunks = [x.chunk(n, 0) for x in xs]
    out = []
    for c in range(n):
        acc = torch.zeros_like(chunks[0][c])
        for k in range(n - 1):
            acc = chunks[(c - (n - 1) + k) % n][c] + acc
        out.append(acc + chunks[c][c])
    return torch.cat(out)


def timed_ms(torch, device, fn, reps=3):
    """Median ms of ``fn`` on this rank, synchronised, after one warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        sync(torch, device)
        t0 = time.perf_counter()
        fn()
        sync(torch, device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def collectives_on_card(torch, rank, device="cuda", shape=PAR_PAYLOAD, gp=PAR_GPIPE):
    """Phase 39 on one rank: every collective on float32 and int32 payloads
    of ``shape`` (each rank's drawn from its seed, so every rank knows all
    of them), held to host references, and gpipe over 4 stages."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.mesh import make_mesh, mesh_axis
    from repro_torch.parallel.pipeline import gpipe

    mesh = make_mesh((PAR_RANKS,), ("model",), device=device)
    ax = mesh_axis(mesh, "model")
    i, n = ax.index, ax.size

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    res = {"checks": {}, "ms": {}}
    payloads = {
        "f32": [torch.randn(shape, generator=gen(1000 + r), device=device) for r in range(n)],
        "i32": [torch.randint(-2 ** 20, 2 ** 20, shape, generator=gen(1100 + r), device=device,
                              dtype=torch.int32) for r in range(n)]}
    for dt, xs in payloads.items():
        host = [x.cpu() for x in xs]
        ring_ref = ring_reference(torch, host, n)
        x = xs[i]
        ring = C.ring_all_reduce(x, ax, impl="ring")
        psum = C.ring_all_reduce(x, ax, impl="psum")
        rs = C.ring_reduce_scatter(x, ax, 0)
        ag = C.ring_all_gather(rs, ax, 0)
        slabs = x.view(n, shape[0] // n, *shape[1:])
        be = C.binary_exchange_all_to_all(slabs, ax)
        bl = C.all_to_all_baseline(slabs, ax)
        want_a2a = torch.stack([h.view(n, shape[0] // n, *shape[1:])[i] for h in host])
        total = sum(host[1:], host[0])
        checks = res["checks"]
        checks[f"ring_{dt}"] = torch.equal(ring.cpu(), ring_ref)
        checks[f"rs_{dt}"] = torch.equal(rs.cpu(), ring_ref.chunk(n, 0)[i])
        checks[f"ag_{dt}"] = torch.equal(ag.cpu(), ring_ref)
        checks[f"binary_{dt}"] = torch.equal(be.cpu(), want_a2a)
        checks[f"xla_{dt}"] = torch.equal(bl.cpu(), want_a2a)
        if dt == "i32":
            checks["psum_i32"] = torch.equal(psum.cpu(), total)
        else:
            res["psum_f32_err"] = float((psum.cpu() - total).abs().max())
            checks["psum_f32"] = res["psum_f32_err"] <= PAR_PSUM_TOL
        if dt == "f32":
            res["ms"] = {
                "ring_all_reduce": timed_ms(torch, device, lambda: C.ring_all_reduce(x, ax)),
                "psum": timed_ms(torch, device, lambda: C.ring_all_reduce(x, ax, impl="psum")),
                "ring_reduce_scatter": timed_ms(torch, device,
                                                lambda: C.ring_reduce_scatter(x, ax, 0)),
                "ring_all_gather": timed_ms(torch, device, lambda: C.ring_all_gather(rs, ax, 0)),
                "binary_exchange": timed_ms(torch, device,
                                            lambda: C.binary_exchange_all_to_all(slabs, ax)),
                "all_to_all_baseline": timed_ms(torch, device,
                                                lambda: C.all_to_all_baseline(slabs, ax))}
        del ring, psum, rs, ag, be, bl
    del payloads
    n_micro, mb, width = gp
    ws = [torch.randn((width, width), generator=gen(2000 + s), device=device) / math.sqrt(width)
          for s in range(n)]
    x_mb = torch.randn((n_micro, mb, width), generator=gen(3000), device=device)
    stage_fn = lambda s, v: torch.tanh(v @ ws[s])
    out = gpipe(stage_fn, x_mb, group=ax, n_micro=n_micro)
    seq = x_mb
    for s in range(n):
        seq = torch.tanh(seq @ ws[s])
    res["gpipe_err"] = float((out - seq).abs().max())
    res["checks"]["gpipe"] = res["gpipe_err"] <= 1e-5
    res["ms"]["gpipe"] = timed_ms(torch, device,
                                  lambda: gpipe(stage_fn, x_mb, group=ax, n_micro=n_micro))
    return res


def shared_copy(torch, t):
    """A host copy of ``t`` in shared memory, which the ranks spawned
    later map without another copy."""
    out = torch.empty(t.shape, dtype=t.dtype).share_memory_()
    return out.copy_(t)


def grads_of(torch, model, batch, moe_ctx=None):
    """(hidden states of the whole sequence, loss, {name: gradient}) of one
    training forward (remat) and backward; under sequence parallelism the
    hidden states are gathered from the ranks' slices."""
    from repro_torch.models import forward, lm_loss
    from repro_torch.models.transformer import full_sequence

    names, params = zip(*model.named_parameters())
    h = forward(model, batch, moe_ctx=moe_ctx)
    loss = lm_loss(model, h, batch["labels"])
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    return full_sequence(h.detach(), batch["tokens"].shape[1]), loss.detach(), grads


def mixtral_reference(torch, cfg, device="cuda", seq=PAR_SEQ):
    """The unsharded port on one process: in float32 batch 0's hidden
    states, loss and every gradient, and for the (2, 2) mesh both batches'
    hidden states, their mean loss and mean gradients (what its data shards
    average to; host copies the ranks map from shared memory); in bf16
    batch 0's hidden states and loss, the mean loss and gradient norm of
    batches 0 and 1, then one AdamW step on batch 0 (its gradient norm and
    the loss after it)."""
    from repro_torch.train import TrainConfig, init_opt_state, loss_fn, make_train_step
    from repro_torch.train.optimizer import global_norm

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b0, b1 = par_batches(cfg, device, seq)
    model = par_draw(torch, cfg, device, torch.float32)
    h0, l0, g0 = grads_of(torch, model, b0)
    h1, l1, g1 = grads_of(torch, model, b1)
    h0 = shared_copy(torch, h0)
    ref = {"float32": {"h": h0, "loss": float(l0),
                       "grads": {n: shared_copy(torch, g) for n, g in g0.items()}}}
    ref["float32 (2, 2)"] = {"h": [h0, shared_copy(torch, h1)],
                             "loss": (float(l0) + float(l1)) / 2,
                             "grads": {n: shared_copy(torch, g.add_(g1[n]).div_(2))
                                       for n, g in g0.items()}}
    del model, h0, h1, l0, l1, g0, g1
    gc.collect()
    torch.cuda.empty_cache()
    model = par_draw(torch, cfg, device, torch.bfloat16)
    h, l0, g0 = grads_of(torch, model, b0)
    _, l1, g1 = grads_of(torch, model, b1)
    bf = {"h": h.cpu(), "loss": float(l0)}
    bf["mean_loss"] = (float(l0) + float(l1)) / 2
    bf["mean_grad_norm"] = float(global_norm((g0[n].float() + g1[n].float()) / 2 for n in g0))
    del g0, g1, h
    tc = TrainConfig()
    state = {"params": model, "opt": init_opt_state(model, tc.opt)}
    state, m = make_train_step(cfg, tc)(state, b0)
    with torch.no_grad():
        bf["post_loss"] = float(loss_fn(model, b0, tc))
    bf["grad_norm"] = float(m["grad_norm"])
    ref["bfloat16"] = bf
    del state, model, m, b0, b1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"parallel: the unsharded reference of {cfg.name} at {depth(cfg)} (B=1, S={seq}; "
          f"float32 and bf16 on batches 0 and 1, one bf16 AdamW step) took "
          f"{time.perf_counter() - t0:.1f} s; float32 loss {ref['float32']['loss']:.5f}, "
          f"bf16 loss {bf['loss']:.5f}, grad norm {bf['grad_norm']:.5f}, after the step "
          f"{bf['post_loss']:.5f}")
    return ref


def mixtral_sharded(torch, rank, ref, cfg, device="cuda", seq=PAR_SEQ):
    """Phase 40 on one rank: the sharded port against the unsharded one."""
    from repro_torch.convert import shard_params
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models import forward, lm_loss
    from repro_torch.models.transformer import full_sequence
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules
    from repro_torch.parallel.specs import param_pspecs, shard_tensor
    from repro_torch.train import TrainConfig, init_opt_state, loss_fn, make_train_step
    from repro_torch.train import sync_gradients

    res = {"errs": {}, "s": {}}
    rules = mesh_axes()
    b0, b1 = par_batches(cfg, device, seq)
    f32, bf = ref["float32"], ref["bfloat16"]
    clock = [time.perf_counter()]

    def mark(name):
        sync(torch, device)
        now = time.perf_counter()
        res["s"][name] = now - clock[0]
        clock[0] = now

    def sharded(mesh, dtype, *impls):
        """This rank's shards of the seeded weights, one model a moe_impl."""
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        full = par_draw(torch, cfg, device, dtype)
        out = [shard_params(full, mesh, impl) for impl in impls]
        del full
        return out

    def step_of(model, batch, moe_ctx):
        """Hidden states, loss and gradient norm of one training forward
        and backward, the loss and gradients averaged over data."""
        h, loss, grads = grads_of(torch, model, batch, moe_ctx)
        impl = moe_ctx.get("moe_impl", "tp")
        loss, norm = sync_gradients(model, loss, grads, TrainConfig(moe_impl=impl))
        return h, float(loss), float(norm), grads

    def against(label, model, mesh, batch, moe_ctx, want):
        """The step's hidden states, loss and every gradient against the
        unsharded port's (``want``)."""
        h, loss, _, grads = step_of(model, batch, moe_ctx)
        errs = {"hidden": rel_errs(torch, h, want["h"]),
                "loss": (abs(loss - want["loss"]) / abs(want["loss"]),) * 2}
        specs = param_pspecs(model, moe_ctx.get("moe_impl", "tp"))
        worst = (0.0, 0.0, "")
        for name, g in grads.items():
            e = rel_errs(torch, g, shard_tensor(want["grads"][name], specs[name], mesh))
            if e[0] >= worst[0]:
                worst = (e[0], e[1], name)
        errs["grads"] = worst[:2]
        res[f"worst_grad_{label}"] = worst[2]
        res["errs"][label] = errs

    # (data=1, model=4), float32: tp mode at the config's capacity factor
    # against the unsharded port, then at capacity factor 16 ep mode with
    # both exchanges against tp mode (every token kept)
    mesh = make_mesh((1, PAR_RANKS), ("data", "model"), device=device)
    with parallel_rules(rules, mesh):
        m_tp, m_ep = sharded(mesh, torch.float32, "tp", "ep")
        mark("float32 draw")
        for ar in ("psum", "ring"):
            against(f"float32 (1, 4) tp ar={ar}", m_tp, mesh, b0,
                    {"moe_impl": "tp", "ar_impl": ar}, f32)
            mark(f"float32 (1, 4) {ar}")
        # capacity factor 16 keeps every token, so both modes route alike:
        # ep's forward and loss against tp's
        m_tp.cfg = m_ep.cfg = dataclasses.replace(cfg, capacity_factor=PAR_EP_CF)
        with torch.no_grad():
            h_tp = forward(m_tp, b0, moe_ctx={"moe_impl": "tp"}, remat=False)
            l_tp = float(lm_loss(m_tp, h_tp, b0["labels"]))
            del m_tp
            for a2a in ("binary", "xla"):
                h = forward(m_ep, b0, moe_ctx={"moe_impl": "ep", "a2a_impl": a2a}, remat=False)
                loss = float(lm_loss(m_ep, h, b0["labels"]))
                res["errs"][f"float32 cf16 ep a2a={a2a} vs tp"] = {
                    "hidden": rel_errs(torch, h, h_tp), "loss": (abs(loss - l_tp) / l_tp,) * 2}
                del h
        del m_ep, h_tp
        mark("float32 cf16 tp, ep x2")
    # (data=2, model=2): in float32 each data shard's hidden states, and the
    # loss and every gradient averaged over data, against the unsharded
    # port's; in bf16 the averaged loss and gradient norm
    mesh22 = make_mesh((2, PAR_RANKS // 2), ("data", "model"), device=device)
    d = mesh22.get_coordinate()[0]
    with parallel_rules(rules, mesh22):
        model, = sharded(mesh22, torch.float32, "tp")
        f22 = ref["float32 (2, 2)"]
        against("float32 (2, 2) tp", model, mesh22, (b0, b1)[d], {"moe_impl": "tp"},
                {"h": f22["h"][d], "loss": f22["loss"], "grads": f22["grads"]})
        del model
        mark("float32 (2, 2)")
        model, = sharded(mesh22, torch.bfloat16, "tp")
        _, loss, norm, _ = step_of(model, (b0, b1)[d], {"moe_impl": "tp"})
        res["bf16_2x2"] = {"loss": abs(loss - bf["mean_loss"]) / bf["mean_loss"],
                           "grad norm": abs(norm - bf["mean_grad_norm"]) / bf["mean_grad_norm"]}
        del model
        mark("bf16 (2, 2)")
    # (data=1, model=4), bf16: the main path
    with parallel_rules(rules, mesh):
        model, m_ep = sharded(mesh, torch.bfloat16, "tp", "ep")
        res["drops_ep"] = moe_drops(torch, m_ep, b0, {"moe_impl": "ep"})
        del m_ep
        with torch.no_grad():
            h = forward(model, b0)
            loss = float(lm_loss(model, h, b0["labels"]))
            h = full_sequence(h, seq)
        res["bf16_hidden"] = rel_errs(torch, h, bf["h"])
        res["bf16_loss"] = abs(loss - bf["loss"]) / bf["loss"]
        del h
        res["drops_tp"] = moe_drops(torch, model, b0, {"moe_impl": "tp"})
        mark("bf16 draw, drops")
        tc = TrainConfig()
        state = {"params": model, "opt": init_opt_state(model, tc.opt)}
        step = make_train_step(cfg, tc)
        sync(torch, device)
        flash_attention.launches = flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        state, m = step(state, b0)
        sync(torch, device)
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
        res["launches"] = {"fwd": flash_attention.launches, "bwd": flash_attention_bwd.launches}
        res["grad_norm"] = float(m["grad_norm"])
        with torch.no_grad():
            res["post_loss"] = float(loss_fn(model, b0, tc))
        del state, model, m, step
    gc.collect()
    mark("bf16 step")
    return res


def parallel_rank(rank, ref, device="cuda", cfg=None, shape=PAR_PAYLOAD, gp=PAR_GPIPE,
                  seq=PAR_SEQ):
    """One rank of phases 39-40 (a process of spawn_world's world)."""
    import torch

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    out = {"collectives": collectives_on_card(torch, rank, device, shape, gp), "t0": t0}
    out["t39"] = time.time() - t0
    out["mixtral"] = mixtral_sharded(torch, rank, ref, cfg or par_cfg(), device, seq)
    return out


def parallel_on_card(torch, device="cuda", cfg=None, shape=PAR_PAYLOAD, gp=PAR_GPIPE,
                     seq=PAR_SEQ):
    """Phases 39-40: the unsharded reference here, then PAR_RANKS ranks
    sharing the card over gloo."""
    from repro_torch.parallel.mesh import spawn_world

    cfg = cfg or par_cfg()
    ref = mixtral_reference(torch, cfg, device, seq)
    t0, wall0 = time.perf_counter(), time.time()
    outs = spawn_world(parallel_rank, PAR_RANKS, ref, device, cfg, shape, gp, seq,
                       backend="gloo", timeout_s=600)
    world_s = time.perf_counter() - t0
    print(f"parallel: the world's ranks started {max(o['t0'] for o in outs) - wall0:.1f} s "
          f"after the spawn; phase 39 took {max(o['t39'] for o in outs):.1f} s; phase 40's "
          f"parts (s, worst rank): " + ", ".join(
              f"{k} {max(o['mixtral']['s'][k] for o in outs):.1f}"
              for k in outs[0]["mixtral"]["s"]))
    label = f"{PAR_RANKS} ranks sharing one {'H100' if device == 'cuda' else 'CPU'} over gloo"
    # phase 39
    bad = sorted({k for o in outs for k, ok in o["collectives"]["checks"].items() if not ok})
    if bad:
        raise AssertionError(f"parallel: collectives disagree with their references: {bad}")
    ms = {k: [o["collectives"]["ms"][k] for o in outs] for k in outs[0]["collectives"]["ms"]}
    print(f"parallel: phase 39, {label}: ring all-reduce, psum, reduce-scatter, all-gather, "
          f"binary exchange, all-to-all on float32 and int32 {shape} payloads equal their host "
          f"references (rings bit for bit in their order of adds, integers exactly, psum within "
          f"{max(o['collectives']['psum_f32_err'] for o in outs):.2e}), gpipe over "
          f"{PAR_RANKS} stages {gp} within {max(o['collectives']['gpipe_err'] for o in outs):.2e}"
          f" of the stages in sequence")
    for k, v in ms.items():
        what = f"over {gp} microbatches" if k == "gpipe" else f"of a float32 {shape} payload"
        print(f"parallel: time {k} {what} ({label}), ms per call by rank: "
              + ", ".join(f"{t:.2f}" for t in v))
    # phase 40
    mx = [o["mixtral"] for o in outs]
    for run in mx[0]["errs"]:
        worst = {part: max(m["errs"][run][part] for m in mx) for part in mx[0]["errs"][run]}
        print(f"parallel: {cfg.name} {run}: " + ", ".join(
            f"{part} err {e[0]:.3e} (max {e[1]:.3e})" for part, e in worst.items()))
        for part, e in worst.items():
            if not e[0] <= PAR_TOL["float32"]:
                raise AssertionError(f"parallel: {run} {part} off by {e[0]:.3e} (over the "
                                     f"reference's norm); worst gradients "
                                     f"{[m.get('worst_grad_' + run) for m in mx]}")
    bf = ref["bfloat16"]
    scal = {"loss": max(m["bf16_loss"] for m in mx),
            "grad norm": max(abs(m["grad_norm"] - bf["grad_norm"]) / bf["grad_norm"]
                             for m in mx),
            "loss after the step": max(abs(m["post_loss"] - bf["post_loss"]) / bf["post_loss"]
                                       for m in mx),
            "(2, 2) mean loss": max(m["bf16_2x2"]["loss"] for m in mx),
            "(2, 2) gradient norm": max(m["bf16_2x2"]["grad norm"] for m in mx)}
    launches = [m["launches"] for m in mx]
    want = {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers}
    hid = max(m["bf16_hidden"][0] for m in mx), max(m["bf16_hidden"][1] for m in mx)
    print(f"parallel: bf16 at (data=2, model=2), the data shards' mean against the unsharded "
          f"port's on both batches, and the main path at (data=1, model={PAR_RANKS}), one "
          f"AdamW step through make_train_step: against the unsharded bf16 port " + ", ".join(
              f"{k} within {v:.2e}" for k, v in scal.items())
          + f"; hidden states {hid[0]:.3e} of their norm (max {hid[1]:.3e}); flash launches a rank {launches} (want {want}); ms per step by "
          f"rank " + ", ".join(f"{m['step_ms']:.1f}" for m in mx) + f" ({label})")
    if not all(v <= PAR_TOL["bfloat16"] for v in scal.values()):
        raise AssertionError(f"parallel: the sharded bf16 step disagrees with the unsharded "
                             f"one: {scal}")
    if device == "cuda" and any(l != want for l in launches):
        raise AssertionError(f"parallel: flash launches a rank {launches}, want {want}")
    tp_drop = [m["drops_tp"] for m in mx]
    ep_drop = [m["drops_ep"] for m in mx]
    print(f"parallel: dropped expert assignments (bf16) at capacity factor "
          f"{cfg.capacity_factor}: tp mode {tp_drop[0][0]} of {tp_drop[0][1]} "
          f"({tp_drop[0][0] / tp_drop[0][1]:.2%}, every rank routes all tokens), ep mode "
          f"{sum(d for d, _ in ep_drop)} of {sum(a for _, a in ep_drop)} "
          f"({sum(d for d, _ in ep_drop) / sum(a for _, a in ep_drop):.2%}: each rank routes "
          f"{seq // PAR_RANKS} tokens with its own capacity)")
    print(f"parallel: phases 39-40 took {world_s:.1f} s in the world of {PAR_RANKS} ranks")
    return {"collectives_ms": ms, "launches": launches, "step_ms": [m["step_ms"] for m in mx],
            "drops_tp": tp_drop, "drops_ep": ep_drop, "bf16": scal,
            "errs": {k: max(max(e[0] for e in m["errs"][k].values()) for m in mx)
                     for k in mx[0]["errs"]}}


def elastic_on_card(torch, device="cuda"):
    """Phase 41: ElasticRunner training reduced H2O-Danube on ``device``
    under tests/test_system.py's fault and straggler schedules."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train import (OptConfig, TrainConfig, checkpoint, init_train_state,
                                   make_train_step, synthetic_batch)
    from repro_torch.train.elastic import ElasticConfig, ElasticRunner

    cfg = get_arch("h2o-danube").reduced()
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
    res = {}

    def runner_for(d, every, batch, seq):
        built = []
        # the same batch every step: a step's loss depends on the state
        # alone, so the steps recomputed after the rollback repeat theirs
        b = {k: torch_from(v, device) for k, v in synthetic_batch(cfg, 0, batch, seq).items()}

        def build_step(mesh, plan, dp):
            built.append((mesh, dp))
            state = init_train_state(cfg, tc, 0, device=device, dtype=torch.float32)
            return state, make_train_step(cfg, tc), iter(lambda: b, None)

        ecfg = ElasticConfig(num_nodes=64, gpus_per_node=4, tp_size=16, dp_size=14,
                             checkpoint_every=every)
        return ElasticRunner(ecfg, d, build_step, device=device), built

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        runner, built = runner_for(d, 5, 4, 32)
        flash_attention.launches = 0
        _, losses = runner.run(total_steps=18, fault_schedule={9: {3, 4}})
        launches = flash_attention.launches
        faults = [e for e in runner.events if e[0] == "fault"]
        last = checkpoint.latest_step(d)
        files = sorted(p.name for p in Path(d).glob("step*.npz"))
    # steps 5-8 ran before the fault at step 9 and again after the restore
    # of the checkpoint of step 4
    first, again = losses[5:9], losses[9:13]
    diff = max(abs(a - b) for a, b in zip(first, again))
    ok = (len(faults) == 1 and 0 < faults[0][2] < 0.01 and last is not None and
          len(losses) == 22 and diff <= 1e-6 and all(math.isfinite(x) for x in losses) and
          all(m is None for m, _ in built) and (device != "cuda" or launches > 0))
    print(f"elastic: reduced {cfg.name} on {device}, 64 nodes x 4 GPUs, TP 16, DP 14, a fault "
          f"at step 9 on nodes {{3, 4}}: {len(faults)} fault event, settled in "
          f"{faults[0][2] * 1e3:.3f} ms, DP {built[0][1]} -> {built[-1][1]}, checkpoints "
          f"{files}, {len(losses)} steps run; steps 5-8 recomputed after the restore "
          f"{'bit-identical' if diff == 0 else f'within {diff:.2e}'} to the first pass "
          f"({first[0]:.6f} ... {first[-1]:.6f}); {launches} flash launches; one process, so "
          f"no mesh is built (the plan needs 224 ranks)")
    if not ok:
        raise AssertionError(f"elastic: the fault run failed its checks (events {runner.events},"
                             f" last checkpoint {last}, losses {losses})")
    times = {i: 1.0 for i in range(8)}
    times[5] = 3.0                       # node 5 straggles at step 4
    with tempfile.TemporaryDirectory() as d:
        runner, built = runner_for(d, 3, 2, 16)
        _, losses = runner.run(total_steps=10, straggler_schedule={4: times})
        sev = [e for e in runner.events if e[0] == "straggler"]
        nf = len([e for e in runner.events if e[0] == "fault"])
    print(f"elastic: straggler schedule (node 5 at 3x the median at step 4): events "
          f"{sev}, then {nf} fault event; node 5 "
          f"{'is' if 5 in runner.cm.physical_faults else 'is not'} marked faulty; "
          f"{len(losses)} steps run; phase 41 took {time.perf_counter() - t0:.1f} s")
    if sev != [("straggler", 4, (5,))] or nf != 1 or 5 not in runner.cm.physical_faults \
            or len(losses) < 10:
        raise AssertionError(f"elastic: the straggler run failed its checks {runner.events}")
    res.update(fault_launches=launches, recompute_diff=diff, dp=[dp for _, dp in built])
    return res


# phase 43: StarCoder2-3B at full width, SPF_LAYERS layers, B = 1, S = SPF_SEQ a
# data shard, sharded over PAR_RANKS ranks of the one card under four rule sets
SPF_LAYERS = 4
SPF_F32_LAYERS = 2
SPF_SEQ = 4096
SPF_CONFIGS = (("(1, 4) seq_sp None", (1, 4), {"seq_sp": None}),
               ("(1, 4) SP", (1, 4), {}),
               ("(2, 2) SP", (2, 2), {}),
               ("(2, 2) SP + FSDP", (2, 2), {"fsdp": "data"}))
SPF_F32_RULES = {"fsdp": "data"}


def spf_cfg(layers, reduced=False):
    """StarCoder2-3B at ``layers`` layers (``reduced``: the reduced config,
    which rehearses phase 43 on the CPU)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("starcoder2")
    return dataclasses.replace(cfg.reduced() if reduced else cfg, num_layers=layers)


def spf_reference(torch, device="cuda", seq=SPF_SEQ, reduced=False):
    """Phase 43's unsharded port on one process: in bf16 at SPF_LAYERS
    layers the loss and gradient norm of batch 0 and the mean loss and the
    mean gradient's norm of batches 0 and 1; in float32 at SPF_F32_LAYERS
    layers both batches' hidden states, their mean loss and mean gradients
    (host copies the ranks map from shared memory)."""
    from repro_torch.train.optimizer import global_norm

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = spf_cfg(SPF_LAYERS, reduced)
    b0, b1 = par_batches(cfg, device, seq)
    model = par_draw(torch, cfg, device, torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = sum(p.numel() for layer in model.layers for p in layer.parameters())
    _, l0, g0 = grads_of(torch, model, b0)
    _, l1, g1 = grads_of(torch, model, b1)
    ref = {"bf16": {"loss": float(l0), "grad_norm": float(global_norm(g0.values())),
                    "mean_loss": (float(l0) + float(l1)) / 2,
                    "mean_grad_norm": float(global_norm((g0[n].float() + g1[n].float()) / 2
                                                       for n in g0))},
           "params": n_params, "layer_params": n_layers}
    del model, g0, g1, l0, l1
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    cfg2 = spf_cfg(SPF_F32_LAYERS, reduced)
    model = par_draw(torch, cfg2, device, torch.float32)
    h0, l0, g0 = grads_of(torch, model, b0)
    h1, l1, g1 = grads_of(torch, model, b1)
    ref["float32"] = {"h": [shared_copy(torch, h0), shared_copy(torch, h1)],
                      "loss": (float(l0) + float(l1)) / 2,
                      "grads": {n: shared_copy(torch, g.add_(g1[n]).div_(2))
                                for n, g in g0.items()}}
    del model, h0, h1, g0, g1, b0, b1
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"sp/fsdp: the unsharded reference of StarCoder2-3B at {SPF_LAYERS} layers "
          f"({n_params / 1e9:.3f} B parameters, {n_layers / 1e9:.3f} B in layers; bf16, "
          f"B=1, S={seq}, batches 0 and 1) and at {SPF_F32_LAYERS} layers in float32 took "
          f"{time.perf_counter() - t0:.1f} s; bf16 loss {ref['bf16']['loss']:.5f}, gradient "
          f"norm {ref['bf16']['grad_norm']:.5f}")
    return ref


def spf_rank(rank, ref, device="cuda", seq=SPF_SEQ, reduced=False):
    """One rank of phase 43: each rule set's bf16 AdamW steps (peak memory,
    ms, flash launches, loss and gradient norm), then the float32 check."""
    import torch

    from repro_torch.convert import shard_params
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules
    from repro_torch.parallel.specs import param_pspecs, shard_tensor
    from repro_torch.train import TrainConfig, init_opt_state, make_train_step
    from repro_torch.train import sync_gradients

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    t_rank = time.perf_counter()
    cfg = spf_cfg(SPF_LAYERS, reduced)
    batches = par_batches(cfg, device, seq)
    tc = TrainConfig()
    out = {"runs": {}}
    for label, shape, rules in SPF_CONFIGS:
        mesh = make_mesh(shape, ("data", "model"), device=device)
        d = mesh.get_coordinate()[0]
        with parallel_rules(mesh_axes(rules), mesh):
            full = par_draw(torch, cfg, device, torch.bfloat16)
            model = shard_params(full, mesh)
            del full
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            state = {"params": model, "opt": init_opt_state(model, tc.opt)}
            state_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
            step = make_train_step(cfg, tc)
            run = {"state_gb": state_gb, "ms": []}
            for i in range(2):
                sync(torch, device)
                flash_attention.launches = flash_attention_bwd.launches = 0
                t0 = time.perf_counter()
                state, m = step(state, batches[d])
                sync(torch, device)
                run["ms"].append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    run["loss"], run["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
            run["launches"] = {"fwd": flash_attention.launches, "bwd": flash_attention_bwd.launches}
            run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
            out["runs"][label] = run
            del state, model, step, m
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    # float32: SP + FSDP at (2, 2) against the unsharded port
    cfg2 = spf_cfg(SPF_F32_LAYERS, reduced)
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    d = mesh.get_coordinate()[0]
    f32 = ref["float32"]
    with parallel_rules(mesh_axes(SPF_F32_RULES), mesh):
        full = par_draw(torch, cfg2, device, torch.float32)
        model = shard_params(full, mesh)
        del full
        h, loss, grads = grads_of(torch, model, batches[d])
        loss, _ = sync_gradients(model, loss, grads, tc)
        specs = param_pspecs(model)
        errs = {"hidden": rel_errs(torch, h, f32["h"][d]),
                "loss": (abs(float(loss) - f32["loss"]) / abs(f32["loss"]),) * 2}
        worst = (0.0, 0.0, "")
        for name, g in grads.items():
            e = rel_errs(torch, g, shard_tensor(f32["grads"][name], specs[name], mesh))
            if e[0] >= worst[0]:
                worst = (e[0], e[1], name)
        errs["grads"] = worst[:2]
        out["f32"] = {"errs": errs, "worst_grad": worst[2],
                      "fsdp_leaves": sum(1 for sp in specs.values() if "data" in sp)}
        del model, grads, h
    out["seconds"] = time.perf_counter() - t_rank
    return out


def sp_fsdp_on_card(torch, device="cuda", seq=SPF_SEQ, reduced=False):
    """Phase 43: sequence parallelism and FSDP on StarCoder2-3B, PAR_RANKS
    ranks sharing the card over gloo (``reduced`` and ``device="cpu"``
    rehearse it on the CPU)."""
    from repro_torch.parallel.mesh import spawn_world

    ref = spf_reference(torch, device, seq, reduced)
    t0 = time.perf_counter()
    outs = spawn_world(spf_rank, PAR_RANKS, ref, device, seq, reduced, backend="gloo",
                       timeout_s=600)
    world_s = time.perf_counter() - t0
    want = {"fwd": 2 * SPF_LAYERS, "bwd": SPF_LAYERS}
    bf = ref["bf16"]
    label = f"{PAR_RANKS} ranks sharing one {'H100' if device == 'cuda' else 'CPU'} over gloo"
    res = {}
    for name, shape, _ in SPF_CONFIGS:
        runs = [o["runs"][name] for o in outs]
        wl, wn = ((bf["loss"], bf["grad_norm"]) if shape[0] == 1
                  else (bf["mean_loss"], bf["mean_grad_norm"]))
        loss_err = max(abs(r["loss"] - wl) / wl for r in runs)
        norm_err = max(abs(r["grad_norm"] - wn) / wn for r in runs)
        launches = [r["launches"] for r in runs]
        print(f"sp/fsdp: StarCoder2-3B at {SPF_LAYERS} layers, bf16, B=1, S={seq} a data "
              f"shard, AdamW, {name} ({label}): state after init_opt_state by rank "
              + ", ".join(f"{r['state_gb']:.3f}" for r in runs) + " GB, peak allocated "
              + ", ".join(f"{r['peak_gb']:.3f}" for r in runs) + " GB; ms a step (first, "
              "second) " + ", ".join(f"{r['ms'][0]:.0f}/{r['ms'][1]:.0f}" for r in runs)
              + f"; flash launches a rank {launches[0]} (want {want}); loss "
              f"{runs[0]['loss']:.5f}, gradient norm {runs[0]['grad_norm']:.5f} against the "
              f"unsharded port's {wl:.5f}, {wn:.5f}: within {loss_err:.2e} and {norm_err:.2e}")
        if not (loss_err <= PAR_TOL["bfloat16"] and norm_err <= PAR_TOL["bfloat16"]):
            raise AssertionError(f"sp/fsdp: {name} disagrees with the unsharded port: loss "
                                 f"{loss_err:.3e}, gradient norm {norm_err:.3e}")
        if device == "cuda" and any(l != want for l in launches):
            raise AssertionError(f"sp/fsdp: {name} flash launches a rank {launches}, want {want}")
        res[name] = {"state_gb": [r["state_gb"] for r in runs],
                     "peak_gb": [r["peak_gb"] for r in runs],
                     "ms": [r["ms"] for r in runs], "launches": launches,
                     "loss_err": loss_err, "norm_err": norm_err}
    errs = {part: (max(o["f32"]["errs"][part][0] for o in outs),
                   max(o["f32"]["errs"][part][1] for o in outs))
            for part in outs[0]["f32"]["errs"]}
    print(f"sp/fsdp: float32 at {SPF_F32_LAYERS} layers, (2, 2), SP + FSDP "
          f"({outs[0]['f32']['fsdp_leaves']} leaves split over data) against the unsharded "
          f"port: " + ", ".join(f"{part} err {e[0]:.3e} (max {e[1]:.3e})"
                                for part, e in errs.items()))
    if not all(e[0] <= PAR_TOL["float32"] for e in errs.values()):
        raise AssertionError(f"sp/fsdp: the float32 SP + FSDP step disagrees: {errs}; worst "
                             f"gradients {[o['f32']['worst_grad'] for o in outs]}")
    per = 16 / 1e9
    width = spf_cfg(SPF_LAYERS, reduced).d_model
    print(f"sp/fsdp: predicted state at 16 B a parameter: (2, 2) "
          f"{(ref['layer_params'] / 2 + (ref['params'] - ref['layer_params']) / 2) * per:.2f} "
          f"GB a rank, with FSDP {(ref['layer_params'] / 4 + (ref['params'] - ref['layer_params']) / 2) * per:.2f} GB "
          f"(the embedding has no fsdp dimension); the {SPF_LAYERS} saved layer inputs at "
          f"(1, 4) {SPF_LAYERS * seq * width * 2 / 1e6:.0f} MB a rank without SP, "
          f"{SPF_LAYERS * seq * width * 2 / 4 / 1e6:.0f} MB with it")
    print(f"sp/fsdp: phase 43 took {world_s:.1f} s in the world of {PAR_RANKS} ranks "
          f"(ranks' own {max(o['seconds'] for o in outs):.1f} s)")
    return {"runs": res, "f32": {k: v[0] for k, v in errs.items()}, "seconds": world_s}


# phase 44: the recurrent layers under a model axis: Mamba2-780m and
# RecurrentGemma-2B at full width, REC_LAYERS layers each, B = 1, S = REC_SEQ a
# data shard, over PAR_RANKS ranks of the one card
REC_LAYERS = {"mamba2": 4, "recurrentgemma": 3}
# phase 46's recurrent runs keep their depths
DEC_REC_LAYERS = {"mamba2": 8, "recurrentgemma": 6}
REC_SEQ = 1024                   # RecurrentGemma's 2048 window binds at neither length
REC_STEPS = 3
# Float32 gradients are held to the same weights' gradients in float64
# (plain_kernels), each rank's shard over its own norm.  The SSD leaves (A_log,
# dt_bias, D) sum terms of both signs over every token, and a shard of a
# few heads can have a norm far below the leaf's, so the unsharded float32
# port's same shard is itself ~1e-4 of its norm away from float64: a
# sharded shard may be REC_ROOM times as far from float64 as the unsharded
# port's same shard is, and PAR_TOL["float32"] in any case.  A sharding
# fault (a missed all-reduce, a wrong shard) is O(1e-1) and more.
REC_ROOM = 4.0
# adamw_lowmem.  In float32 at (1, 4), at the CPU test's settings
# (tests/test_torch_parallel_recurrent.py), so that three steps move each
# weight by ~lr, the state after REC_STEPS steps is held to the unsharded
# steps': the factored second moments (vr, vc), which the means over split
# dimensions make, each over its own norm (a missed all-reduce leaves
# 1 / model of the sum); each rank's master shards, their max error over
# the steps' summed lr (the same fault scales the rows' updates by ~2).
# In bf16 at (2, 2), at the default settings, the step's scalars
# (PAR_TOL): bf16 rounding flips the sign of small gradient entries, whose
# weights Adam then moves by 2 lr the other way, so bf16 weights are not
# held entry by entry.
REC_OPT = {"lr": 3e-3, "warmup_steps": 2, "eps": 1e-6}
REC_V_TOL = 1e-3
REC_MASTER_TOL = 5e-2


def rec_cfgs(reduced=False, layers=None):
    """Phase 44's configs by alias, at REC_LAYERS or ``layers`` (``reduced``:
    the reduced configs at the same depths, which rehearse the phase on the
    CPU)."""
    from repro_torch.configs import get_arch

    return {arch: dataclasses.replace(get_arch(arch).reduced() if reduced else get_arch(arch),
                                      num_layers=n)
            for arch, n in (layers or REC_LAYERS).items()}


def rec_train_cfg(microbatches=1, cpu_test=False):
    """adamw_lowmem at the default settings, or (``cpu_test``) at REC_OPT."""
    from repro_torch.train import OptConfig, TrainConfig

    return TrainConfig(opt=OptConfig(name="adamw_lowmem", **(REC_OPT if cpu_test else {})),
                       microbatches=microbatches)


def rec_sum_lr():
    from repro_torch.train.optimizer import _lr_at

    return sum(_lr_at(rec_train_cfg(cpu_test=True).opt, i) for i in range(REC_STEPS))


def rec_steps(torch, cfg, model, batch, tc):
    """REC_STEPS train steps of ``model`` on ``batch``: (state, [(loss,
    gradient norm)], [ms])."""
    from repro_torch.train import init_opt_state, make_train_step

    state = {"params": model, "opt": init_opt_state(model, tc.opt)}
    step = make_train_step(cfg, tc)
    dev = "cuda" if next(model.parameters()).is_cuda else "cpu"
    scalars, ms = [], []
    for _ in range(REC_STEPS):
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        scalars.append((float(m["loss"]), float(m["grad_norm"])))
    return state, scalars, ms


@contextlib.contextmanager
def plain_kernels():
    """The model's flash-attention and SSD-scan entry points run their
    plain versions, differentiated by autograd, on any device: for phase
    44's float64 reference on the card, which no kernel takes.  Restored
    on exit."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import layers, ssm

    def flash(q, k, v, **opts):
        return flash_attention_fwd_ref(q, k, v, **opts)[0]

    def scan(x, dt, A, B, C, *, chunk=128, out_dtype=None):
        return ssd_scan_ref(x, dt, A, B, C, chunk, out_dtype)

    saved = layers._flash_kernel, ssm.ssd_scan
    layers._flash_kernel, ssm.ssd_scan = flash, scan
    try:
        yield
    finally:
        layers._flash_kernel, ssm.ssd_scan = saved


def rec_reference(torch, device="cuda", seq=REC_SEQ, reduced=False):
    """Phase 44's unsharded port on one process: in float32 batch 0's
    hidden states, loss and gradients; the same weights' gradients in
    float64 (:func:`plain_kernels`, float64 for float64 inputs; the model's
    own float32 casts, each one rounding, stay), rounded to float32; in
    float32 REC_STEPS adamw_lowmem steps at REC_OPT on batch 0, with the
    master weights and factored second moments after them; in bf16
    REC_STEPS adamw_lowmem steps on batches 0 and 1 together
    (what the (2, 2) mesh's data shards see), as two microbatches: each
    one's bf16 gradients are summed in float32, as each data shard's are
    computed alone and then averaged (one batch of both would accumulate
    the embedding's scatter-add over twice the repeated tokens in bf16,
    which moved RecurrentGemma-2B's gradient norm by 1.6%).  Tensors go to
    the ranks as host copies in shared memory."""
    t0 = time.perf_counter()
    ref, f64_s = {}, {}
    for arch, cfg in rec_cfgs(reduced).items():
        b0, b1 = par_batches(cfg, device, seq)
        model = par_draw(torch, cfg, device, torch.float32)
        h, loss, grads = grads_of(torch, model, b0)
        h, loss = shared_copy(torch, h), float(loss)
        grads = {n: shared_copy(torch, g) for n, g in grads.items()}
        t64 = time.perf_counter()
        model.to(torch.float64)
        with plain_kernels():
            _, _, g64 = grads_of(torch, model, b0)
        g64 = {n: shared_copy(torch, g.float()) for n, g in g64.items()}
        f64_s[arch] = time.perf_counter() - t64
        ref[arch] = {"float32": {"h": h, "loss": loss, "grads32": grads, "grads": g64}}
        del model, grads, g64
        gc.collect()
        state, scalars, _ = rec_steps(torch, cfg, par_draw(torch, cfg, device, torch.float32),
                                      b0, rec_train_cfg(cpu_test=True))
        opt = state["opt"]
        ref[arch]["lowmem"] = {
            "scalars": scalars,
            "master": {n: shared_copy(torch, t) for n, t in opt["master"].items()},
            "v": {n: {k: shared_copy(torch, t) for k, t in v.items()}
                  for n, v in opt["v"].items() if "vr" in v}}
        del state, opt
        gc.collect()
        both = {k: torch.cat([b0[k], b1[k]]) for k in b0}
        _, scalars, _ = rec_steps(torch, cfg, par_draw(torch, cfg, device, torch.bfloat16),
                                  both, rec_train_cfg(2))
        ref[arch]["bf16"] = scalars
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    print(f"recurrent: the unsharded references (Mamba2-780m at {REC_LAYERS['mamba2']} and "
          f"RecurrentGemma-2B at {REC_LAYERS['recurrentgemma']} layers, B=1, S={seq}: float32 "
          f"and float64 gradients (the latter "
          + ", ".join(f"{a} {t:.1f} s" for a, t in f64_s.items())
          + f"), {REC_STEPS} float32 adamw_lowmem steps at B=1 and {REC_STEPS} bf16 at B=2) took "
          f"{time.perf_counter() - t0:.1f} s")
    return ref


def rec_rank(rank, ref, device="cuda", seq=REC_SEQ, reduced=False):
    """One rank of phase 44: each config in float32 at (1, 4) (hidden
    states and loss against the unsharded port, every gradient after
    sync_gradients over its norm against float64, with the step's kernel
    launches) and REC_STEPS float32 adamw_lowmem steps at REC_OPT (scalars,
    this rank's master shards and factored second moments against the
    unsharded steps'), then REC_STEPS bf16 adamw_lowmem steps at (2, 2)
    (scalars)."""
    import torch

    from repro_torch.convert import shard_params
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules
    from repro_torch.parallel.specs import opt_pspecs, param_pspecs, shard_tensor
    from repro_torch.train import sync_gradients

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_rank = time.perf_counter()
    counters = (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd)
    sum_lr = rec_sum_lr()
    out = {}
    for arch, cfg in rec_cfgs(reduced).items():
        batches = par_batches(cfg, device, seq)
        f32 = ref[arch]["float32"]
        res = {}
        mesh = make_mesh((1, 4), ("data", "model"), device=device)
        with parallel_rules(mesh_axes(), mesh):
            full = par_draw(torch, cfg, device, torch.float32)
            specs = param_pspecs(full)
            model = shard_params(full, mesh)
            del full
            for c in counters:
                c.launches = 0
            h, loss, grads = grads_of(torch, model, batches[0])
            loss, _ = sync_gradients(model, loss, grads, rec_train_cfg())
            res["launches"] = {c.__name__: c.launches for c in counters}
            g64 = {n: shard_tensor(f32["grads"][n], specs[n], mesh) for n in grads}
            res["f32"] = {
                "hidden": rel_errs(torch, h, f32["h"])[0],
                "loss": abs(float(loss) - f32["loss"]) / abs(f32["loss"]),
                "grads": {n: rel_errs(torch, g, g64[n])[0] for n, g in grads.items()},
                "unsharded": {n: rel_errs(torch, shard_tensor(f32["grads32"][n], specs[n], mesh),
                                          g64[n])[0]
                              for n in grads}}
            layer = next(ly for ly in model.layers if ly.kind in ("ssd", "rglru"))
            sub = layer.ssd if layer.kind == "ssd" else layer.rglru
            res["local"] = {"heads": int(sub["w_dt"].shape[-1]) if layer.kind == "ssd" else 0,
                            "width": int((sub["w_x"]).shape[-1])}
            del grads, h, g64
            vspecs = opt_pspecs(specs, model, "adamw_lowmem")["v"]
            state, scalars, _ = rec_steps(torch, cfg, model, batches[0],
                                          rec_train_cfg(cpu_test=True))
            want = ref[arch]["lowmem"]
            res["lowmem"] = {
                "scalars": scalars,
                "master": {n: float((t - shard_tensor(want["master"][n], specs[n], mesh)
                                     .to(t.device)).abs().max()) / sum_lr
                           for n, t in state["opt"]["master"].items()},
                "moments": {f"{n}.{k}": rel_errs(torch, t, shard_tensor(want["v"][n][k],
                                                                        vspecs[n][k], mesh))[0]
                            for n, v in state["opt"]["v"].items() if "vr" in v
                            for k, t in v.items()},
                "factored": sum(1 for v in state["opt"]["v"].values() if "vr" in v)}
            del state, model
        gc.collect()
        mesh = make_mesh((2, 2), ("data", "model"), device=device)
        d = mesh.get_coordinate()[0]
        with parallel_rules(mesh_axes(), mesh):
            model = shard_params(par_draw(torch, cfg, device, torch.bfloat16), mesh)
            for c in counters:
                c.launches = 0
            _, scalars, ms = rec_steps(torch, cfg, model, batches[d], rec_train_cfg())
            res["bf16"] = {"scalars": scalars, "ms": ms,
                           "launches": {c.__name__: c.launches for c in counters}}
            del model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        out[arch] = res
    out["seconds"] = time.perf_counter() - t_rank
    return out


def _worst(errs):
    """(largest value, its key) of a dict of errors."""
    return max((e, k) for k, e in errs.items())


def recurrent_on_card(torch, device="cuda", seq=REC_SEQ, reduced=False):
    """Phase 44: SSD and RG-LRU layers and adamw_lowmem under a model axis,
    PAR_RANKS ranks sharing the card over gloo (``reduced`` and
    ``device="cpu"`` rehearse it on the CPU)."""
    from repro_torch.parallel.mesh import spawn_world

    ref = rec_reference(torch, device, seq, reduced)
    t0 = time.perf_counter()
    outs = spawn_world(rec_rank, PAR_RANKS, ref, device, seq, reduced, backend="gloo",
                       timeout_s=600)
    world_s = time.perf_counter() - t0
    label = f"{PAR_RANKS} ranks sharing one {'H100' if device == 'cuda' else 'CPU'} over gloo"
    tol = PAR_TOL["float32"]
    res = {}
    for arch, cfg in rec_cfgs(reduced).items():
        runs = [o[arch] for o in outs]
        # by (leaf, rank): the sharded shard's and the unsharded port's same
        # shard's errors against float64, and the first's limit
        sharded = {(n, i): e for i, r in enumerate(runs) for n, e in r["f32"]["grads"].items()}
        unsharded = {(n, i): e for i, r in enumerate(runs)
                     for n, e in r["f32"]["unsharded"].items()}
        limit = {k: max(tol, REC_ROOM * e) for k, e in unsharded.items()}
        hidden = max(r["f32"]["hidden"] for r in runs)
        loss_err = max(r["f32"]["loss"] for r in runs)
        n_attn = sum(cfg.pattern_at(i) in ("attn", "swa", "chunked")
                     for i in range(cfg.num_layers))
        n_ssd = sum(cfg.pattern_at(i) == "ssd" for i in range(cfg.num_layers))
        want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
                "ssd_scan": 2 * n_ssd, "ssd_scan_bwd": n_ssd}
        launches = [r["launches"] for r in runs]
        local = runs[0]["local"]
        top = sorted(sharded, key=sharded.get, reverse=True)[:3]
        ratio = _worst({n: sharded[n] / limit[n] for n in sharded})
        print(f"recurrent: {cfg.name} at {cfg.num_layers} layers, float32, B=1, S={seq}, "
              f"(1, 4) ({label}), {local['heads']} SSD heads and {local['width']} channels a "
              f"rank: hidden err {hidden:.3e}, loss err {loss_err:.3e} against the unsharded "
              f"port; gradient shards over their norm against float64, sharded (the unsharded "
              f"float32 port's same shard): "
              + ", ".join(f"{n} rank {i} {sharded[n, i]:.3e} ({unsharded[n, i]:.3e})"
                          for n, i in top)
              + f", {len(runs[0]['f32']['grads'])} gradients, the largest unsharded "
              f"{_worst(unsharded)[0]:.3e} ({'{} rank {}'.format(*_worst(unsharded)[1])}), "
              f"the largest share of its limit {ratio[0]:.3f} "
              f"({'{} rank {}'.format(*ratio[1])}); launches a rank and step {launches[0]} "
              f"(want {want})")
        if not (hidden <= tol and loss_err <= tol and ratio[0] <= 1.0):
            raise AssertionError(f"recurrent: {cfg.name} sharded float32 disagrees: hidden "
                                 f"{hidden:.3e}, loss {loss_err:.3e}, gradient {ratio[1]} "
                                 f"{sharded[ratio[1]]:.3e} over its limit {limit[ratio[1]]:.3e}")
        if device == "cuda" and any(l != want for l in launches):
            raise AssertionError(f"recurrent: {cfg.name} launches {launches}, want {want}")
        def scalar_err(part, wl):
            return max(max(abs(a - c) / abs(c), abs(b - e) / abs(e))
                       for r in runs for (a, b), (c, e) in zip(r[part]["scalars"], wl))

        def scalars(sc):
            return ", ".join(f"{a:.5f}/{b:.5f}" for a, b in sc)

        low = ref[arch]["lowmem"]["scalars"]
        low_err = scalar_err("lowmem", low)
        moments = _worst({k: e for r in runs for k, e in r["lowmem"]["moments"].items()})
        master = _worst({k: e for r in runs for k, e in r["lowmem"]["master"].items()})
        print(f"recurrent: {cfg.name} float32, {REC_STEPS} adamw_lowmem steps at (1, 4), "
              + ", ".join(f"{k} {v:g}" for k, v in REC_OPT.items())
              + f" ({runs[0]['lowmem']['factored']} factored second moments a rank): "
              f"losses/gradient norms {scalars(runs[0]['lowmem']['scalars'])} against the "
              f"unsharded steps' {scalars(low)}: within {low_err:.2e}; factored second "
              f"moments over their norm {moments[0]:.3e} ({moments[1]}); master shards' max "
              f"error over the summed lr {rec_sum_lr():g} {master[0]:.3e} ({master[1]})")
        if not (low_err <= tol and moments[0] <= REC_V_TOL and master[0] <= REC_MASTER_TOL):
            raise AssertionError(f"recurrent: {cfg.name} float32 adamw_lowmem steps disagree: "
                                 f"scalars {low_err:.3e}, second moments {moments}, "
                                 f"masters {master}")
        wl = ref[arch]["bf16"]
        scal_err = scalar_err("bf16", wl)
        bl = [r["bf16"]["launches"] for r in runs]
        print(f"recurrent: {cfg.name} bf16, {REC_STEPS} adamw_lowmem steps at (2, 2): "
              f"losses/gradient norms {scalars(runs[0]['bf16']['scalars'])} against the "
              f"unsharded step's {scalars(wl)}: within {scal_err:.2e}; ms a step by rank "
              + "; ".join("/".join(f"{t:.0f}" for t in r["bf16"]["ms"]) for r in runs)
              + f"; launches a rank in {REC_STEPS} steps {bl[0]}")
        if not scal_err <= PAR_TOL["bfloat16"]:
            raise AssertionError(f"recurrent: {cfg.name} bf16 adamw_lowmem steps disagree: "
                                 f"{scal_err:.3e}")
        if device == "cuda" and any(l != {k: REC_STEPS * v for k, v in want.items()}
                                    for l in bl):
            raise AssertionError(f"recurrent: {cfg.name} bf16 launches {bl}")
        res[arch] = {"f32": {"hidden": hidden, "loss": loss_err, "grads": max(sharded.values()),
                             "unsharded": max(unsharded.values()),
                             "limit_share": ratio[0]},
                     "bf16_err": scal_err, "lowmem": {"scalars": low_err, "moments": moments[0],
                                                       "master": master[0]},
                     "launches": launches, "bf16_launches": bl, "local": local}
    print(f"recurrent: phase 44 took {world_s:.1f} s in the world of {PAR_RANKS} ranks "
          f"(ranks' own {max(o['seconds'] for o in outs):.1f} s)")
    res["seconds"] = world_s
    return res


# phase 45: the dry run against the card: phase 43's StarCoder2-3B step under
# its four rule sets, predicted on meta tensors in a fake world of PAR_RANKS
# ranks and run for real on the ranks sharing the card; then production cells
DRY_CELLS = (("starcoder2-3b", "train_4k"), ("mixtral-8x7b", "prefill_32k"),
             ("mamba2-780m", "train_4k"), ("llama4-maverick-400b-a17b", "train_4k"))
ALLOC_ROUND = 512                # the caching allocator rounds each block up to this


def dry_predict(seq=SPF_SEQ, reduced=False):
    """Phase 45's prediction, in a process of its own: each rule set's
    StarCoder2 step traced on meta tensors as rank 0 of a fake world of
    PAR_RANKS ranks (every rank's shards have rank 0's shapes)."""
    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.parallel.mesh import fake_world, make_mesh
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules

    cfg = spf_cfg(SPF_LAYERS, reduced)
    out = {}
    with fake_world(PAR_RANKS):
        for label, shape, rules in SPF_CONFIGS:
            t0 = time.perf_counter()
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            batch = {k: torch.empty((1, seq), dtype=torch.int32, device="meta")
                     for k in ("tokens", "labels")}
            with parallel_rules(mesh_axes(rules), mesh):
                fn, args = D.train_step(cfg, mesh, batch)
                sizes = D.storages(D.tensors(args)).values()
                _, rec = D.measure(fn, args)
            rec["argument_bytes_rounded"] = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND
                                                for n in sizes)
            rec["trace_s"] = time.perf_counter() - t0
            out[label] = rec
    return out


def dry_cells(results):
    """The production cells of DRY_CELLS on the single mesh, each traced in
    its fake world of 256 ranks, records under ``results``."""
    from repro_torch.launch import dryrun as D

    D.RESULTS = Path(results)
    return {f"{a}--{s}": D.run_cell(a, s, False, force=True) for a, s in DRY_CELLS}


def _child(call: str) -> list:
    """A command running ``chip_smoke.<call>`` in a fresh interpreter that
    prints its JSON result as its last line."""
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"print(json.dumps(chip_smoke.{call}))")
    return [sys.executable, "-c", code]


def _child_result(proc, label, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode:
        raise RuntimeError(f"{label} failed (exit {proc.returncode}):\n{out[-4000:]}\n"
                           f"{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def host_refs(path):
    """The numpy references of the zoo, the sweep's first rows, the
    8192-node placement, the traffic replay and the 8192-node cost and
    matrix grids, which need no card: pickled to ``path``; returns each
    one's seconds."""
    refs = {"zoo": zoo_refs(), "sweep": sweep_ref(), "dc": dc_refs(), "traffic": traffic_ref(),
            "cost": cost_ref(), "matrix": matrix_ref()}
    with open(path, "wb") as f:
        pickle.dump(refs, f, protocol=pickle.HIGHEST_PROTOCOL)
    return {"zoo": {n: v[1] for n, v in refs["zoo"].items()},
            "dc": {tp: v[1] for tp, v in refs["dc"].items()},
            **{k: refs[k][1] for k in ("sweep", "traffic", "cost", "matrix")}}


class Background:
    """``chip_smoke.<fn>(path)`` in a process of its own, started at once,
    which pickles its result to ``path``: work that needs little or none
    of the card runs beside the phases.  ``get`` waits for the result;
    ``close`` stops the process if it still runs."""

    def __init__(self, fn, label):
        self.label = label
        self.dir = tempfile.TemporaryDirectory()
        self.path = str(Path(self.dir.name) / "result.pkl")
        self.proc = subprocess.Popen(_child(f"{fn}({self.path!r})"),
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.result = None

    def get(self, key=None):
        if self.result is None:
            _child_result(self.proc, self.label, timeout=1200)
            with open(self.path, "rb") as f:
                self.result = pickle.load(f)
        return self.result if key is None else self.result[key]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self.dir.cleanup()


def dry_rank(rank, device="cuda", seq=SPF_SEQ, reduced=False, dec_ref=None, ep=False):
    """One rank of phase 45: each rule set's StarCoder2 step for real under
    OpAnalysis, with the bytes its setup allocated (the state and the
    batch), its peak above them and its flash launches; then, given phase
    46's references ``dec_ref``, phase 46's rank in the same world, and with
    ``ep`` phase 47's.  Returns (phase 45's runs, phase 46's or None, phase
    47's or None)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def held():
        if not cuda:
            return 0, 0
        st = torch.cuda.memory_stats()
        return st.get("requested_bytes.all.current", -1), st["allocated_bytes.all.current"]

    t_rank = time.perf_counter()
    cfg = spf_cfg(SPF_LAYERS, reduced)
    batches = par_batches(cfg, device, seq)
    out = {}
    for label, shape, rules in SPF_CONFIGS:
        mesh = make_mesh(shape, ("data", "model"), device=device)
        d = mesh.get_coordinate()[0]
        with parallel_rules(mesh_axes(rules), mesh):
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            req0, alloc0 = held()
            batch = {k: v.clone() for k, v in batches[d].items()}
            fn, args = D.train_step(cfg, mesh, batch, device=device, seed=PAR_SEED)
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            req1, alloc1 = held()
            flash_attention.launches = flash_attention_bwd.launches = 0
            t0 = time.perf_counter()
            _, rec = D.measure(fn, args)
            sync(torch, device)
            run = {"rec": rec, "ms": (time.perf_counter() - t0) * 1e3,
                   "requested": req1 - req0, "allocated": alloc1 - alloc0,
                   "peak": (torch.cuda.max_memory_allocated() - alloc1) if cuda else 0,
                   "launches": {"flash_attention": flash_attention.launches,
                                "flash_attention_bwd": flash_attention_bwd.launches}}
            out[label] = run
            del fn, args, batch, rec
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_rank
    dec = None if dec_ref is None else dec_rank(rank, dec_ref, device, reduced)
    return out, dec, ep_rank(rank, device, reduced) if ep else None


def dryrun_on_card(torch, device="cuda", seq=SPF_SEQ, reduced=False, cells=None,
                   decode=False, ep=False):
    """Phase 45: the dry run's prediction of phase 43's step against the
    step on PAR_RANKS ranks of the card (``reduced`` and ``device="cpu"``
    rehearse it on the CPU); then the production cells, whose dry run
    ``cells`` (a running child process) started earlier.  With ``decode``
    the same world then runs phase 46, whose results go under "decode", and
    with ``ep`` phase 47, under "ep"."""
    from repro_torch.parallel.mesh import spawn_world

    t0 = time.perf_counter()
    children = [subprocess.Popen(_child(f"dry_predict({seq}, {reduced})"),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    try:
        dec_ref = None
        if decode:
            children.append(subprocess.Popen(_child(f"dec_predict({reduced})"),
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
            dec_ref = dec_reference(torch, device, reduced)
        if ep:
            children.append(subprocess.Popen(_child(f"ep_predict({reduced})"),
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
        both = spawn_world(dry_rank, PAR_RANKS, device, seq, reduced, dec_ref, ep,
                           backend="gloo", timeout_s=900)
    except BaseException:
        for proc in children:
            proc.kill()
            proc.communicate()
        raise
    pred = _child_result(children[0], "the dry run's prediction", 300)
    world_s = time.perf_counter() - t0
    outs = [o for o, _, _ in both]
    res = {"runs": {}}
    for label, _, _ in SPF_CONFIGS:
        p = pred[label]
        runs = [o[label] for o in outs]
        pk = {k: v["calls"] for k, v in p["kernels"].items()}
        mem = p["memory"]
        for r in runs:
            rec = r["rec"]
            same = {"flops": rec["cost"]["flops"] == p["cost"]["flops"],
                    "collectives": rec["collectives"] == p["collectives"],
                    "kernels": rec["kernels"] == p["kernels"],
                    "traffic": rec["cost"]["bytes_accessed"] == p["cost"]["bytes_accessed"]}
            if not (same["flops"] and same["collectives"] and same["kernels"]):
                raise AssertionError(f"dryrun: {label}: the prediction differs from the real "
                                     f"run: {same}; predicted {p['cost']}, "
                                     f"{p['collectives']}, {pk}; real {rec['cost']}, "
                                     f"{rec['collectives']}")
            if device == "cuda":
                if r["launches"] != pk:
                    raise AssertionError(f"dryrun: {label}: launches {r['launches']}, "
                                         f"predicted {pk}")
                if r["requested"] != mem["argument_bytes"]:
                    raise AssertionError(f"dryrun: {label}: setup requested {r['requested']} "
                                         f"bytes, predicted {mem['argument_bytes']}")
            r["same"] = same
        print(f"dryrun: StarCoder2-3B at {SPF_LAYERS} layers, bf16, B=1, S={seq} a data shard, "
              f"{label}: predicted argument bytes {mem['argument_bytes']} "
              f"({p['argument_bytes_rounded']} in {ALLOC_ROUND}-byte blocks), setup requested "
              + ", ".join(str(r["requested"]) for r in runs) + " and allocated "
              + ", ".join(str(r["allocated"]) for r in runs) + " by rank; FLOPs "
              f"{p['cost']['flops']:.6e} (real {runs[0]['rec']['cost']['flops']:.6e}), "
              f"bytes accessed {p['cost']['bytes_accessed']:.6e} (equal on "
              f"{sum(r['same']['traffic'] for r in runs)} of {len(runs)} ranks), collectives "
              + ", ".join(f"{k} {int(v['count'])} x {v['bytes'] / 1e6:.1f} MB"
                          for k, v in p["collectives"].items())
              + f" (equal on every rank), kernels {pk}, launches "
              + ", ".join(str(r["launches"]) for r in runs)
              + f"; predicted temp {mem['temp_bytes'] / 1e9:.3f} GB against max allocated "
              f"above the setup " + ", ".join(f"{r['peak'] / 1e9:.3f}" for r in runs)
              + " GB ("
              + ", ".join(f"{mem['temp_bytes'] / r['peak']:.3f}" if r["peak"] else "-"
                          for r in runs)
              + f"); trace {p['trace_s']:.1f} s, the real step "
              + ", ".join(f"{r['ms']:.0f}" for r in runs) + " ms under the analysis")
        res["runs"][label] = {
            "argument_bytes": mem["argument_bytes"],
            "requested": [r["requested"] for r in runs],
            "allocated": [r["allocated"] for r in runs],
            "temp_ratio": [mem["temp_bytes"] / r["peak"] if r["peak"] else None for r in runs],
            "launches": [r["launches"] for r in runs], "predicted": pk,
            "flops": p["cost"]["flops"]}
    if cells is not None:
        total = torch.cuda.get_device_properties(0).total_memory if device == "cuda" else 0
        recs = _child_result(cells, "the production cells' dry run", 600)
        res["cells"] = {}
        for key, rec in recs.items():
            if rec["status"] != "ok":
                raise AssertionError(f"dryrun: {key} failed: {rec.get('error')}")
            m = rec["memory"]
            res["cells"][key] = {"trace_s": rec["trace_s"], **m,
                                 "flops": rec["cost"]["flops"],
                                 "wire_bytes": rec["loop_aware"]["collective_wire_bytes"],
                                 "opt": rec.get("opt")}
            print(f"dryrun: {key} on the single mesh (256 ranks, rank 0): traced in "
                  f"{rec['trace_s']:.1f} s; a rank's arguments {m['argument_bytes'] / 1e9:.3f} "
                  f"GB + temp {m['temp_bytes'] / 1e9:.3f} GB = "
                  f"{(m['argument_bytes'] + m['temp_bytes']) / 1e9:.3f} GB against the card's "
                  f"total_memory {total / 1e9:.3f} GB; FLOPs {rec['cost']['flops']:.4e}, "
                  f"collective wire bytes {rec['loop_aware']['collective_wire_bytes']:.4e}"
                  + (f", {rec['opt']}" if rec.get("opt") else ""))
    if decode:
        res["decode"] = decode_mesh_check(torch, [o for _, o, _ in both], dec_ref, children[1],
                                          device, reduced)
    if ep:
        res["ep"] = ep_check(torch, [o for _, _, o in both], children[-1], device, reduced)
    own = max(o["seconds"] for o in outs)
    print(f"dryrun: phase 45{' and 46' if decode else ''}{' and 47' if ep else ''} took "
          f"{time.perf_counter() - t0:.1f} s (the world and the predictions {world_s:.1f} s, "
          f"phase 45's ranks' own {own:.1f} s)")
    res["seconds"] = time.perf_counter() - t0
    return res


# phase 46: decode under a mesh, PAR_RANKS ranks sharing the card over gloo,
# each run held to the unsharded port on the card with the same weights
# (heads padded for PAR_RANKS; kvdedup's KV heads unpadded): StarCoder2-3B
# tensor-parallel at (1, 4) in bf16 and in float32, phase 44's recurrent
# configs at (1, 4) in float32, a cache split over data at (4, 1) (one lane,
# long_500k's layout: StarCoder2-3B over 32,768 slots, and Mixtral-8x7B's
# 4096-slot window wrapped, the writing rank moving from rank 0 to rank 1),
# kvdedup at (1, 4); then the dry run of the bf16 step against the step.
DEC_TOL = 2e-5                   # float32 cache shards, each over its norm
DEC_SEED = 11


def dec_sizes(reduced=False):
    """Phase 46's sizes (``reduced``: the reduced configs' sizes, which
    rehearse the phase on the CPU)."""
    if reduced:
        return {"layers": 2, "f32_layers": 2, "lanes": 8, "prompt": 8, "new": 8,
                "cache": 64, "rec": (4, 4), "seq_slots": 64, "seq_steps": 8}
    return {"layers": 8, "f32_layers": 2, "lanes": 8, "prompt": 32, "new": 32,
            "cache": 1024, "rec": (8, 9), "seq_slots": 32768, "seq_steps": 8}


def dec_cfg(arch, layers, reduced=False):
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    return dataclasses.replace(cfg.reduced() if reduced else cfg, num_layers=layers)


def dec_model(torch, cfg, device, dtype, kv_pad=True):
    """Phase 46's full weights, drawn from PAR_SEED with heads padded for
    PAR_RANKS (``kv_pad=False``: the KV heads unpadded, as kvdedup holds
    them)."""
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator(device=device).manual_seed(PAR_SEED),
                       tp=PAR_RANKS, device=device, dtype=dtype, kv_pad=kv_pad)


def dec_feed(torch, model, cache, prompts, new, pos0=0, seq_sharded=False, moe_ctx=None):
    """``prompts`` (lanes, P) fed one token a step through decode_step, as
    repro's engine feeds a prompt, then ``new`` - 1 greedy tokens, every
    lane at one position from ``pos0``; tokens and positions go in as device
    tensors; the MoE layers run as ``moe_ctx`` says.  Returns every step's
    next tokens (lanes, P + new - 1) on the host and the ms a step."""
    from repro_torch.models import decode_step

    dev = model.device
    lanes, p = prompts.shape
    toks = torch.from_numpy(np.ascontiguousarray(prompts, np.int32)).to(dev)
    out, nxt = [], None
    sync(torch, dev)
    t0 = time.perf_counter()
    for i in range(p + new - 1):
        tok = toks[:, i:i + 1] if i < p else nxt[:, None]
        pos = torch.full((lanes,), pos0 + i, dtype=torch.int32, device=dev)
        nxt, _ = decode_step(model, cache, tok, pos, seq_sharded=seq_sharded, moe_ctx=moe_ctx)
        out.append(nxt)
    sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3 / (p + new - 1)
    return torch.stack(out, 1).cpu().numpy(), ms


def dec_fill(torch, cache, start):
    """Every attention layer's ring cache (one lane) as positions 0 ..
    start - 1 leave it: slot j holds the last such t with t % W == j (-1
    where there is none), k and v drawn from DEC_SEED and the layer."""
    for i, c in enumerate(cache):
        if "k" not in c:
            continue
        dev, w = c["k"].device, c["k"].shape[1]
        gen = torch.Generator(device=dev).manual_seed(DEC_SEED + i)
        for name in ("k", "v"):
            c[name].copy_(torch.randn(c[name].shape, generator=gen, device=dev))
        j = torch.arange(w, device=dev)
        t = start - 1 - torch.remainder(start - 1 - j, w)
        c["pos"].copy_(torch.where(t >= 0, t, torch.full_like(t, -1))[None].expand_as(c["pos"]))


def dec_seq_runs(reduced=False):
    """The (4, 1) runs: (key, arch, layers, dtype name, cache length, first
    position): StarCoder2-3B over seq_slots slots filled below seq_slots -
    seq_steps, in float32 and bf16; Mixtral-8x7B at one layer, its window
    wrapped three times and the steps crossing from rank 0's slots into
    rank 1's."""
    sz = dec_sizes(reduced)
    w = dec_cfg("mixtral", 1, reduced).window
    first = sz["seq_slots"] - sz["seq_steps"]
    return (("seq_f32", "starcoder2", sz["f32_layers"], "float32", sz["seq_slots"], first),
            ("seq_bf16", "starcoder2", sz["f32_layers"], "bfloat16", sz["seq_slots"], first),
            ("window", "mixtral", 1, "float32", w, 3 * w + w // PAR_RANKS - sz["seq_steps"] // 2))


def dec_written(start, steps, w):
    """The global slots the steps from position ``start`` write."""
    return [(start + i) % w for i in range(steps)]


def dec_reference(torch, device="cuda", reduced=False):
    """Phase 46's unsharded port on one process: each run's next tokens and
    the caches it leaves (host copies in shared memory; of a run over a
    filled cache only the written slots and every slot's position)."""
    from repro_torch.models import init_cache

    t0 = time.perf_counter()
    sz = dec_sizes(reduced)
    lanes = sz["lanes"]
    rng = np.random.default_rng(DEC_SEED)
    sc = dec_cfg("starcoder2", sz["layers"], reduced)
    ref = {"prompts": rng.integers(0, sc.vocab_size, (lanes, sz["prompt"]))}
    model = dec_model(torch, sc, device, torch.bfloat16)
    cache = init_cache(model, lanes, sz["cache"])
    ref["tp_bf16"] = {"tokens": dec_feed(torch, model, cache, ref["prompts"], sz["new"])[0]}
    del model, cache

    def run(key, cfg, kv_pad, prompts, new):
        model = dec_model(torch, cfg, device, torch.float32, kv_pad)
        cache = init_cache(model, lanes, prompts.shape[1] + new if key in REC_LAYERS
                           else sz["cache"], dtype=torch.float32)
        toks, _ = dec_feed(torch, model, cache, prompts, new)
        ref[key] = {"prompts": prompts, "tokens": toks,
                    "cache": [{k: shared_copy(torch, t) for k, t in c.items()} for c in cache]}

    sc2 = dec_cfg("starcoder2", sz["f32_layers"], reduced)
    run("tp_f32", sc2, True, ref["prompts"], sz["new"])
    run("kvdedup", sc2, False, ref["prompts"], sz["new"])
    p, n = sz["rec"]
    for arch, cfg in rec_cfgs(reduced, DEC_REC_LAYERS).items():
        run(arch, cfg, True, rng.integers(0, cfg.vocab_size, (lanes, p)), n)
    for key, arch, layers, dname, w, start in dec_seq_runs(reduced):
        cfg = dec_cfg(arch, layers, reduced)
        model = dec_model(torch, cfg, device, getattr(torch, dname))
        cache = init_cache(model, 1, w, dtype=getattr(torch, dname))
        dec_fill(torch, cache, start)
        prompts = rng.integers(0, cfg.vocab_size, (1, sz["seq_steps"]))
        toks, _ = dec_feed(torch, model, cache, prompts, 1, pos0=start)
        slots = dec_written(start, sz["seq_steps"], w)
        ref[key] = {"prompts": prompts, "tokens": toks, "start": start,
                    "written": [{"k": shared_copy(torch, c["k"][:, slots]),
                                 "v": shared_copy(torch, c["v"][:, slots]),
                                 "pos": shared_copy(torch, c["pos"])} for c in cache]}
        del model, cache
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref["seconds"] = time.perf_counter() - t0
    print(f"decode/mesh: the unsharded references took {ref['seconds']:.1f} s")
    return ref


def dec_cache_errs(torch, cache, want):
    """(worst error over the norm of a float tensor, its layer.name, whether
    every position and the shapes are equal) of a cache against its
    expected shard."""
    worst, where, same = 0.0, "", True
    for i, (c, w) in enumerate(zip(cache, want)):
        for name, t in c.items():
            if t.shape != w[name].shape:
                same = False
            elif t.dtype == torch.int32:
                same &= bool(torch.equal(t.cpu(), w[name].cpu()))
            elif (e := rel_errs(torch, t, w[name])[0]) >= worst:
                worst, where = e, f"{i}.{name}"
    return worst, where, same


def dec_rank(rank, ref, device="cuda", reduced=False):
    """One rank of phase 46 (the module's list): each run's next tokens,
    its cache shard against the unsharded port's (shard_cache), ms a step,
    decode_attention launches and the merge's ms; then the bf16 step under
    OpAnalysis with the bytes its setup requested."""
    import torch

    from repro_torch.convert import shard_params
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch import dryrun as D
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models import layers as L
    from repro_torch.parallel.mesh import make_mesh, mesh_axis
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules
    from repro_torch.parallel.specs import cache_pspecs, shard_cache

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_rank = time.perf_counter()
    sz = dec_sizes(reduced)
    lanes = sz["lanes"]
    out = {}
    tp = make_mesh((1, PAR_RANKS), ("data", "model"), device=device)
    sc = dec_cfg("starcoder2", sz["layers"], reduced)
    with parallel_rules(mesh_axes(), tp):
        model = shard_params(dec_model(torch, sc, device, torch.bfloat16), tp)
        cache = init_cache(model, lanes, sz["cache"])
        decode_attention.launches = 0
        toks, ms = dec_feed(torch, model, cache, ref["prompts"], sz["new"])
        out["tp_bf16"] = {"tokens": toks, "ms": ms, "launches": decode_attention.launches,
                          "kv_heads": int(cache[0]["k"].shape[2])}
        del model, cache
    gc.collect()
    sc2 = dec_cfg("starcoder2", sz["f32_layers"], reduced)
    runs = [("tp_f32", sc2, {}, True), ("kvdedup", sc2, {"kv_heads": None, "seq_shard": "model"},
                                        False)]
    runs += [(arch, cfg, {}, True) for arch, cfg in rec_cfgs(reduced, DEC_REC_LAYERS).items()]
    for key, cfg, rules, kv_pad in runs:
        seq = key == "kvdedup"
        r = ref[key]
        with parallel_rules(mesh_axes(rules), tp):
            model = shard_params(dec_model(torch, cfg, device, torch.float32, kv_pad), tp)
            length = sz["cache"] if key in ("tp_f32", "kvdedup") else sum(sz["rec"])
            cache = init_cache(model, lanes, length, dtype=torch.float32, seq_sharded=seq)
            decode_attention.launches = 0
            toks, ms = dec_feed(torch, model, cache, r["prompts"],
                                sz["new"] if key in ("tp_f32", "kvdedup") else sz["rec"][1],
                                seq_sharded=seq)
            launches = decode_attention.launches
            want = shard_cache(r["cache"], cache_pspecs(r["cache"], seq), tp)
            out[key] = {"tokens": toks, "ms": ms, "launches": launches,
                        "errs": dec_cache_errs(torch, cache, want),
                        "local": {k: list(t.shape) for k, t in cache[0].items()}}
            del model, cache, want
        gc.collect()
    dm = make_mesh((PAR_RANKS, 1), ("data", "model"), device=device)
    merges = []
    real_merge = L.merge_partials

    def timed_merge(*args):
        sync(torch, device)
        t0 = time.perf_counter()
        res = real_merge(*args)
        sync(torch, device)
        merges.append((time.perf_counter() - t0) * 1e3)
        return res

    for key, arch, layers, dname, w, start in dec_seq_runs(reduced):
        r = ref[key]
        cfg = dec_cfg(arch, layers, reduced)
        dtype = getattr(torch, dname)
        with parallel_rules(mesh_axes({"batch": None}), dm):
            model = shard_params(dec_model(torch, cfg, device, dtype), dm)
            full = init_cache(model, 1, w, dtype=dtype)
            dec_fill(torch, full, start)
            cache = [{k: t.clone() for k, t in c.items()}
                     for c in shard_cache(full, cache_pspecs(full, True), dm)]
            del full
            idx = mesh_axis(dm, "data").index
            decode_attention.launches = 0
            merges.clear()
            L.merge_partials = timed_merge if key == "seq_f32" else real_merge
            try:
                toks, ms = dec_feed(torch, model, cache, r["prompts"], 1, pos0=start,
                                    seq_sharded=True)
            finally:
                L.merge_partials = real_merge
            launches = decode_attention.launches
            worst, owned, pos_ok = 0.0, 0, True
            for c, wr in zip(cache, r["written"]):
                if "k" not in c:
                    continue
                wl = c["k"].shape[1]
                pos_ok &= bool(torch.equal(c["pos"].cpu(), wr["pos"][:, idx * wl:(idx + 1) * wl]))
                mine = [i for i, g in enumerate(dec_written(start, sz["seq_steps"], w))
                        if g // wl == idx]
                owned += len(mine)
                if mine:
                    loc = [dec_written(start, sz["seq_steps"], w)[i] % wl for i in mine]
                    for name in ("k", "v"):
                        worst = max(worst, rel_errs(torch, c[name][:, loc],
                                                    wr[name][:, mine])[0])
            out[key] = {"tokens": toks, "ms": ms, "launches": launches, "err": worst,
                        "owned": owned, "pos_equal": pos_ok, "slots": int(cache[0]["k"].shape[1]),
                        "merge_ms": sum(merges) / max(1, sz["seq_steps"])}
            del model, cache
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def held():
        if not cuda:
            return 0
        return torch.cuda.memory_stats().get("requested_bytes.all.current", -1)

    with parallel_rules(mesh_axes(), tp):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        req0 = held()
        model = D.sharded_model(sc, tp, device=device, seed=PAR_SEED)
        cache = init_cache(model, lanes, sz["cache"])
        batch = {"tokens": torch.zeros((lanes, 1), dtype=torch.int32, device=device),
                 "position": torch.full((lanes,), sz["prompt"], dtype=torch.int32,
                                        device=device)}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        req1 = held()
        alloc1 = torch.cuda.memory_allocated() if cuda else 0
        decode_attention.launches = 0
        _, rec = D.measure(lambda: decode_step(model, cache, batch["tokens"],
                                               batch["position"]), (model, cache, batch))
        sync(torch, device)
        out["dry"] = {"rec": rec, "requested": req1 - req0, "launches": decode_attention.launches,
                      "peak": (torch.cuda.max_memory_allocated() - alloc1) if cuda else 0}
        del model, cache, batch
    out["seconds"] = time.perf_counter() - t_rank
    return out


def dec_predict(reduced=False):
    """Phase 46's prediction, in a process of its own: the bf16 (1, 4)
    decode step traced on meta tensors as rank 0 of a fake world of
    PAR_RANKS ranks."""
    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.models import decode_step, init_cache
    from repro_torch.parallel.mesh import fake_world, make_mesh
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules

    sz = dec_sizes(reduced)
    lanes = sz["lanes"]
    with fake_world(PAR_RANKS):
        mesh = make_mesh((1, PAR_RANKS), ("data", "model"), device="cpu")
        with parallel_rules(mesh_axes(), mesh):
            model = D.sharded_model(dec_cfg("starcoder2", sz["layers"], reduced), mesh)
            cache = init_cache(model, lanes, sz["cache"])
            batch = {"tokens": torch.empty((lanes, 1), dtype=torch.int32, device="meta"),
                     "position": torch.empty((lanes,), dtype=torch.int32, device="meta")}
            _, rec = D.measure(lambda: decode_step(model, cache, batch["tokens"],
                                                   batch["position"]), (model, cache, batch))
    return rec


def decode_mesh_check(torch, outs, ref, pred_proc, device="cuda", reduced=False):
    """Phase 46, whose ranks ran in phase 45's world (``outs``, their
    results in rank order) on PAR_RANKS ranks sharing the card over gloo:
    each run against the unsharded port (``ref``, made before the world),
    then the dry run's prediction of the bf16 step (``pred_proc``, a child
    process started before the world) against the step."""
    t0 = time.perf_counter()
    sz = dec_sizes(reduced)
    pred = _child_result(pred_proc, "the decode step's dry run", 300)
    cuda = device == "cuda"
    sc = dec_cfg("starcoder2", sz["layers"], reduced)
    steps = sz["prompt"] + sz["new"] - 1
    res = {"launches": {}, "ms": {}}

    def check(ok, what):
        if not ok:
            raise AssertionError(f"decode/mesh: {what}")

    def agreement(key):
        return float(np.mean([np.mean(o[key]["tokens"] == ref[key]["tokens"]) for o in outs]))

    runs = [o["tp_bf16"] for o in outs]
    res["launches"]["tp_bf16"] = [r["launches"] for r in runs]
    res["ms"]["tp_bf16"] = [r["ms"] for r in runs]
    new = slice(sz["prompt"], None)
    print(f"decode/mesh: {sc.name} at {sc.num_layers} layers, bf16, (1, 4), {sz['lanes']} "
          f"lanes, {sz['prompt']} prompt + {sz['new']} new tokens, cache {sz['cache']}, "
          f"{runs[0]['kv_heads']} KV heads a rank: token agreement with the unsharded port "
          f"{agreement('tp_bf16'):.4f} (prompt steps "
          f"{np.mean([np.mean(r['tokens'][:, :sz['prompt']] == ref['tp_bf16']['tokens'][:, :sz['prompt']]) for r in runs]):.4f}, "
          f"generated {np.mean([np.mean(r['tokens'][:, new] == ref['tp_bf16']['tokens'][:, new]) for r in runs]):.4f}); "
          f"ms a step by rank " + ", ".join(f"{r['ms']:.2f}" for r in runs)
          + f"; decode_attention launches by rank {res['launches']['tp_bf16']} "
          f"(want {sc.num_layers} x {steps})")
    check(all(r["tokens"].shape == ref["tp_bf16"]["tokens"].shape for r in runs),
          "bf16 token shapes")
    if cuda:
        check(all(n == sc.num_layers * steps for n in res["launches"]["tp_bf16"]),
              f"bf16 launches {res['launches']['tp_bf16']}")
    res["tp_bf16_agreement"] = agreement("tp_bf16")
    res["errs"] = {}
    for key in ("tp_f32", "kvdedup", *REC_LAYERS):
        runs = [o[key] for o in outs]
        equal = all(np.array_equal(r["tokens"], ref[key]["tokens"]) for r in runs)
        worst = max(r["errs"][0] for r in runs)
        where = max(runs, key=lambda r: r["errs"][0])["errs"][1]
        same = all(r["errs"][2] for r in runs)
        n_steps = ref[key]["tokens"].shape[1]
        print(f"decode/mesh: {key}, float32, (1, 4), {n_steps} steps of {sz['lanes']} lanes: "
              f"tokens equal to the unsharded port's on every rank: {equal}; cache shards "
              f"against shard_cache of its cache, worst error over the norm {worst:.3e} "
              f"({where}; limit {DEC_TOL}), positions and shapes equal: {same}; a rank's "
              f"first layer {runs[0]['local']}; ms a step by rank "
              + ", ".join(f"{r['ms']:.2f}" for r in runs)
              + f"; decode_attention launches by rank {[r['launches'] for r in runs]}")
        check(equal and same and worst <= DEC_TOL, f"{key}: tokens {equal}, cache {worst:.3e} "
              f"({where}), positions and shapes {same}")
        res["errs"][key] = worst
        res["launches"][key] = [r["launches"] for r in runs]
    for key, arch, layers, dname, w, start in dec_seq_runs(reduced):
        runs = [o[key] for o in outs]
        equal = all(np.array_equal(r["tokens"], ref[key]["tokens"]) for r in runs)
        worst = max(r["err"] for r in runs)
        owned = [r["owned"] for r in runs]
        n_attn = attention_layers(dec_cfg(arch, layers, reduced))
        tol = DEC_TOL if dname == "float32" else PAR_TOL["bfloat16"]
        print(f"decode/mesh: {key}: {arch} at {layers} layers, {dname}, (4, 1), one lane, "
              f"{w} slots ({runs[0]['slots']} a rank), {sz['seq_steps']} steps from position "
              f"{start}: tokens equal to the unsharded port's: {equal} (agreement "
              f"{agreement(key):.4f}); written slots by rank {owned}, their k/v against the "
              f"unsharded port's over the norm {worst:.3e} (limit {tol}); positions equal: "
              f"{all(r['pos_equal'] for r in runs)}; ms a step by rank "
              + ", ".join(f"{r['ms']:.2f}" for r in runs)
              + (f"; the merge (a pmax and a psum over data, timed between synchronisations) "
                 f"ms a step by rank " + ", ".join(f"{r['merge_ms']:.3f}" for r in runs)
                 if key == "seq_f32" else "")
              + f"; decode_attention launches by rank {[r['launches'] for r in runs]}")
        check(all(r["pos_equal"] for r in runs) and sum(owned) == n_attn * sz["seq_steps"]
              and worst <= tol, f"{key}: slots {owned}, k/v {worst:.3e}")
        check(equal or dname != "float32", f"{key}: tokens differ")
        if key == "window":
            check(sum(o > 0 for o in owned) >= 2, f"window: writers {owned}")
        if cuda:
            check(all(r["launches"] == n_attn * sz["seq_steps"] for r in runs),
                  f"{key} launches {[r['launches'] for r in runs]}")
        res["errs"][key] = worst
        res["launches"][key] = [r["launches"] for r in runs]
        res["ms"][key] = [r["ms"] for r in runs]
        if key == "seq_f32":
            res["merge_ms"] = [r["merge_ms"] for r in runs]
    dry = [o["dry"] for o in outs]
    pk = {k: v["calls"] for k, v in pred["kernels"].items()}
    for r in dry:
        rec = r["rec"]
        check(rec["cost"]["flops"] == pred["cost"]["flops"]
              and rec["collectives"] == pred["collectives"]
              and rec["kernels"] == pred["kernels"],
              f"dry run: predicted {pred['cost']}, {pred['collectives']}, {pk}; real "
              f"{rec['cost']}, {rec['collectives']}, {rec['kernels']}")
        if cuda:
            check(r["requested"] == pred["memory"]["argument_bytes"],
                  f"dry run: setup requested {r['requested']} bytes, predicted "
                  f"{pred['memory']['argument_bytes']}")
            check({"decode_attention": r["launches"]} == pk,
                  f"dry run: launches {r['launches']}, predicted {pk}")
    mem = pred["memory"]
    print(f"decode/mesh: the dry run of the bf16 (1, 4) step: predicted argument bytes "
          f"{mem['argument_bytes']}, setup requested " + ", ".join(str(r["requested"]) for r in dry)
          + " by rank; FLOPs, collectives ("
          + ", ".join(f"{k} {int(v['count'])} x {v['bytes'] / 1e6:.3f} MB"
                      for k, v in pred["collectives"].items())
          + f") and kernels {pk} equal on every rank; launches "
          + ", ".join(str(r["launches"]) for r in dry)
          + f"; predicted temp {mem['temp_bytes'] / 1e6:.3f} MB against max allocated above "
          f"the setup " + ", ".join(f"{r['peak'] / 1e6:.3f}" for r in dry) + " MB")
    res["dry"] = {"argument_bytes": mem["argument_bytes"],
                  "requested": [r["requested"] for r in dry], "kernels": pk}
    own = max(o["seconds"] for o in outs)
    res["seconds"] = ref["seconds"] + own + time.perf_counter() - t0
    print(f"decode/mesh: phase 46 took {res['seconds']:.1f} s in phase 45's world (the "
          f"unsharded references {ref['seconds']:.1f} s, the ranks' own {own:.1f} s)")
    return res


# phase 47: Llama-4 Maverick at full width and EP_LAYERS layers with its MoE
# layer in ep mode (experts over the model axis, the shared expert over ff),
# in phase 45's world of PAR_RANKS ranks after phase 46, mesh (1, 4), bf16;
# each rank draws only its own shards, leaf by leaf (ep_draw), one mode's
# model at a time
EP_LAYERS = 2                    # a chunked layer with a dense MLP, one with the MoE
EP_SEED = 23
# Llama-4 routes top-1 over 128 experts: at capacity factor E / top_k a
# rank's capacity holds every token it dispatches, so neither mode drops an
# assignment and ep and tp compute the same function
EP_CF = 128.0
EP_REDUCED_CF = 4.0              # the reduced config's 4 experts, top-1
# each row's error over its RMS: the shared-expert check, and ep against tp
EP_ROW_TOL = 2e-2
# the share of hidden-state rows of the ep forward within EP_ROW_TOL of tp
# mode's, and the decode's token agreement with tp mode (PERF.md, PR 31)
EP_ROW_SHARE = 0.99
EP_TOKEN_AGREEMENT = 0.8


def ep_sizes(reduced=False):
    """Phase 47's sizes (``reduced``: a rehearsal on the CPU)."""
    if reduced:
        return {"seq": 64, "tokens": 64, "lanes": 8, "prompt": 8, "new": 8, "cache": 64,
                "f32_seq": 64}
    # at capacity factor 128 tp mode's (E x C, d) buffer holds 128 slots a
    # token: S = 1024 took ~20 GB a rank at its peak, past a quarter of the card
    return {"seq": 512, "tokens": 512, "lanes": 8, "prompt": 32, "new": 32, "cache": 1024,
            "f32_seq": 64}


def ep_cfg(reduced=False, cf=EP_CF):
    """Llama-4 Maverick at EP_LAYERS layers (its reduced config rehearses
    on the CPU) at capacity factor ``cf`` (None: the published one)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("llama4")
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg, num_layers=EP_LAYERS)
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def ep_draw(torch, cfg, mesh, moe_impl, device, dtype=None, seed=EP_SEED):
    """This rank's shards of ``cfg``'s bf16 model (heads padded for
    PAR_RANKS) under ``moe_impl``'s specs and the installed rules, drawn
    without the full model: each leaf is drawn in pieces along its first
    dimension, piece j of leaf i from its own seed, so every rank and both
    modes see the same full leaf, and a rank holds its shards and at most
    one piece (an expert, or rows of 2^25 entries) beside them.  Matrices
    are normal with repro's scales (0.02 for the embedding and the head,
    1/sqrt(fan-in) for the rest); norm scales are zero, as init_params
    makes them."""
    from repro_torch.convert import shard_params
    from repro_torch.models import init_params
    from repro_torch.parallel.specs import param_pspecs, shard_tensor

    dtype = dtype or torch.bfloat16
    if cfg.norm != "rmsnorm" or cfg.qkv_bias or cfg.is_encdec or \
            set(cfg.layer_pattern) & {"ssd", "rglru"}:
        raise ValueError(f"ep_draw draws attention, MLP and MoE leaves of an RMSNorm model, "
                         f"not {cfg.name}'s")
    full = init_params(cfg, None, tp=PAR_RANKS, device="meta", dtype=dtype)
    specs = param_pspecs(full, moe_impl)
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters()}
    model = shard_params(full, mesh, moe_impl).to_empty(device=device)
    del full
    with torch.no_grad():
        for i, (name, p) in enumerate(model.named_parameters()):
            shape, spec = shapes[name], specs[name]
            if len(shape) == 1:
                p.zero_()
                continue
            std = 0.02 if name in ("embed", "lm_head") else 1.0 / math.sqrt(shape[-2])
            rows = shard_tensor(torch.arange(shape[0]), spec[:1], mesh)
            lo, hi = int(rows[0]), int(rows[-1]) + 1
            per = max(1, (1 << 25) // math.prod(shape[1:]))
            for j in range(lo // per, -(-hi // per)):
                a, b = j * per, min((j + 1) * per, shape[0])
                gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i * 4099 + j)
                piece = torch.randn((b - a, *shape[1:]), generator=gen, device=device)
                piece = piece[max(lo - a, 0):min(hi, b) - a]
                p[max(a, lo) - lo:min(b, hi) - lo].copy_(
                    shard_tensor(piece.mul_(std), (None, *spec[1:]), mesh))
                del piece
    return model


def row_rel(torch, got, want):
    """Each row's error over its RMS, (rows,) on the host: the norm of the
    difference over the reference row's norm, in float32."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.to(got.device).float().reshape(-1, got.shape[-1])
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).cpu().numpy()


def ep_shared_check(torch, model, ax, device, reduced=False):
    """The MoE layer's ep output with the shared expert, both exchanges,
    against the ep routed part (the same layer without ``shared``) plus the
    whole shared MLP (its ff shares gathered) on the replicated tokens; and
    a plant that adds only this rank's ff share.  At the published capacity
    factor: the routed part is the same call's, so drops do not matter."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.collectives import ring_all_gather

    cfg = ep_cfg(reduced, cf=None)
    p = next(layer.moe for layer in model.layers if layer.moe is not None)
    t, d = ep_sizes(reduced)["tokens"], cfg.d_model
    gen = torch.Generator(device=device).manual_seed(EP_SEED)
    x = torch.randn((1, t, d), generator=gen, device=device).to(p.w_up.dtype)
    routed = MOE.MoE(p.router, p.w_up, p.w_down, p.w_gate)

    def run(moe, a2a_impl="binary"):
        return MOE.moe_apply_local(moe, cfg, x, moe_impl="ep", a2a_impl=a2a_impl,
                                   tp=ax.size, group=ax)

    with torch.no_grad():
        ys = {a2a: run(p, a2a_impl=a2a).reshape(t, d) for a2a in ("binary", "xla")}
        base = run(routed).reshape(t, d)
        whole = {k: ring_all_gather(v.detach().contiguous(), ax, 1 if k != "w_down" else 0)
                 for k, v in p.shared.items()}
        want = base + L.mlp_apply(whole, x.reshape(t, d), cfg.act)
        plant = base + L.mlp_apply(dict(p.shared), x.reshape(t, d), cfg.act)
    errs = {a2a: row_rel(torch, y, want) for a2a, y in ys.items()}
    bad = row_rel(torch, plant, want)
    return {"max": {k: float(e.max()) for k, e in errs.items()},
            "plant_max": float(bad.max()), "plant_share": float(np.mean(bad <= EP_ROW_TOL)),
            "shared_ff": int(p.shared["w_up"].shape[1]), "whole_ff": int(whole["w_up"].shape[1]),
            "tokens": t}


def ep_f32_check(torch, mesh, device, reduced_seq):
    """Reduced Llama-4 (4 layers, 4 experts, top-1) in float32 at capacity
    factor EP_REDUCED_CF: the ep step at (1, 4) against the unsharded port
    on the same weights: hidden states, loss and every gradient (each
    tensor's error over its norm).  Top-1 routing renormalises the one
    weight to 1, so the routers' gradients are zero but for rounding: they
    are held against the largest entry of any gradient instead."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import shard_params
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules
    from repro_torch.parallel.specs import param_pspecs, shard_tensor
    from repro_torch.train import TrainConfig, sync_gradients

    cfg = dataclasses.replace(get_arch("llama4").reduced(), capacity_factor=EP_REDUCED_CF)
    full = init_params(cfg, torch.Generator(device=device).manual_seed(PAR_SEED),
                       tp=PAR_RANKS, device=device, dtype=torch.float32)
    batch = par_batches(cfg, device, reduced_seq)[0]
    h_ref, l_ref, g_ref = grads_of(torch, full, batch)
    ctx = {"moe_impl": "ep"}
    with parallel_rules(mesh_axes(), mesh):
        model = shard_params(full, mesh, "ep")
        specs = param_pspecs(full, "ep")
        h, loss, grads = grads_of(torch, model, batch, ctx)
        loss, _ = sync_gradients(model, loss, grads, TrainConfig(moe_impl="ep"))
        top = max(float(g.abs().max()) for g in g_ref.values())
        worst, router = (0.0, ""), 0.0
        for name, g in grads.items():
            want = shard_tensor(g_ref[name], specs[name], mesh)
            if name.endswith("moe.router") and cfg.top_k == 1:
                router = max(router, float((g - want).abs().max()) / top)
                continue
            e = rel_errs(torch, g, want)[0]
            if e >= worst[0]:
                worst = (e, name)
    return {"hidden": rel_errs(torch, h, h_ref)[0],
            "loss": abs(float(loss) - float(l_ref)) / abs(float(l_ref)),
            "grads": max(worst[0], router), "worst": worst[1], "router": router,
            "n_grads": len(grads),
            "experts_a_rank": int(model.layers[1].moe.w_up.shape[0])}


def ep_rank(rank, device="cuda", reduced=False):
    """Phase 47 on one rank: for ep and then tp mode, this rank's shards
    drawn (ep_draw), ep mode's shared-expert check, the forward and loss
    at S = EP_SEQ under OpAnalysis, 8 lanes decoded (tokens, launches, ms
    a step), one decode step under OpAnalysis, each with the bytes its
    setup requested; then the float32 step at reduced width."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import dryrun as D
    from repro_torch.models import decode_step, forward, init_cache, lm_loss
    from repro_torch.models.transformer import full_sequence
    from repro_torch.parallel.mesh import make_mesh, mesh_axis
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_rank = time.perf_counter()
    sz = ep_sizes(reduced)
    cfg = ep_cfg(reduced, EP_CF if not reduced else EP_REDUCED_CF)
    mesh = make_mesh((1, PAR_RANKS), ("data", "model"), device=device)
    ax = mesh_axis(mesh, "model")
    lanes = sz["lanes"]
    prompts = np.random.default_rng(EP_SEED).integers(0, cfg.vocab_size, (lanes, sz["prompt"]))

    def settle():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def held():
        return torch.cuda.memory_stats().get("requested_bytes.all.current", -1) if cuda else 0

    out = {}
    with parallel_rules(mesh_axes(), mesh):
        for impl in ("ep", "tp"):
            settle()
            req0 = held()
            t0 = time.perf_counter()
            model = ep_draw(torch, cfg, mesh, impl, device)
            sync(torch, device)
            r = out[impl] = {"model_bytes": held() - req0, "draw_s": time.perf_counter() - t0,
                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0}
            if impl == "ep":
                r["shared"] = ep_shared_check(torch, model, ax, device, reduced)
            ctx = {"moe_impl": impl}
            settle()
            req0 = held()
            batch = par_batches(cfg, device, sz["seq"])[0]
            r["fwd_requested"] = r["model_bytes"] + held() - req0

            def fwd():
                with torch.no_grad():
                    h = forward(model, batch, moe_ctx=ctx, remat=False)
                    return h, lm_loss(model, h, batch["labels"])

            flash_attention.launches = 0
            t0 = time.perf_counter()
            (h, loss), rec = D.measure(fwd, (model, batch))
            sync(torch, device)
            r["fwd"] = {"rec": rec, "launches": flash_attention.launches,
                        "ms": (time.perf_counter() - t0) * 1e3}
            with torch.no_grad():
                r["h"] = full_sequence(h, sz["seq"]).cpu()
            r["loss"] = float(loss)
            del h, loss, batch
            settle()
            cache = init_cache(model, lanes, sz["cache"])
            decode_attention.launches = 0
            toks, ms = dec_feed(torch, model, cache, prompts, sz["new"], moe_ctx=ctx)
            r["dec"] = {"tokens": toks, "ms": ms, "launches": decode_attention.launches}
            del cache
            settle()
            req0 = held()
            cache = init_cache(model, lanes, sz["cache"])
            db = {"tokens": torch.zeros((lanes, 1), dtype=torch.int32, device=device),
                  "position": torch.full((lanes,), sz["prompt"], dtype=torch.int32,
                                         device=device)}
            r["dec_requested"] = r["model_bytes"] + held() - req0
            decode_attention.launches = 0
            _, rec = D.measure(lambda: decode_step(model, cache, db["tokens"], db["position"],
                                                   moe_ctx=ctx), (model, cache, db))
            sync(torch, device)
            r["dec_dry"] = {"rec": rec, "launches": decode_attention.launches}
            del model, cache, db
    settle()
    out["f32"] = ep_f32_check(torch, mesh, device, sz["f32_seq"])
    settle()
    out["seconds"] = time.perf_counter() - t_rank
    return out


def ep_predict(reduced=False):
    """Phase 47's prediction, in a process of its own: ep mode's forward
    and loss and its decode step traced on meta tensors as rank 0 of a fake
    world of PAR_RANKS ranks."""
    import torch

    from repro_torch.launch import dryrun as D
    from repro_torch.models import decode_step, forward, init_cache, lm_loss
    from repro_torch.parallel.mesh import fake_world, make_mesh
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules

    sz = ep_sizes(reduced)
    cfg = ep_cfg(reduced, EP_CF if not reduced else EP_REDUCED_CF)
    ctx = {"moe_impl": "ep"}
    meta = dict(dtype=torch.int32, device="meta")
    with fake_world(PAR_RANKS):
        mesh = make_mesh((1, PAR_RANKS), ("data", "model"), device="cpu")
        with parallel_rules(mesh_axes(), mesh):
            model = D.sharded_model(cfg, mesh, "ep")
            batch = {k: torch.empty((1, sz["seq"]), **meta) for k in ("tokens", "labels")}

            def fwd():
                with torch.no_grad():
                    h = forward(model, batch, moe_ctx=ctx, remat=False)
                    return h, lm_loss(model, h, batch["labels"])

            _, fwd_rec = D.measure(fwd, (model, batch))
            cache = init_cache(model, sz["lanes"], sz["cache"])
            db = {"tokens": torch.empty((sz["lanes"], 1), **meta),
                  "position": torch.empty((sz["lanes"],), **meta)}
            _, dec_rec = D.measure(lambda: decode_step(model, cache, db["tokens"],
                                                       db["position"], moe_ctx=ctx),
                                   (model, cache, db))
    return {"fwd": fwd_rec, "dec": dec_rec}


def ep_check(torch, outs, pred_proc, device="cuda", reduced=False):
    """Phase 47, whose ranks ran in phase 45's world (``outs`` in rank
    order): the shared-expert sum and its plant, ep against tp (hidden
    rows, loss, decode tokens), launches, the dry run's prediction
    (``pred_proc``, a child process) against the measured forward and
    decode step, and the float32 step at reduced width."""
    t0 = time.perf_counter()
    pred = _child_result(pred_proc, "phase 47's dry run", 300)
    cuda = device == "cuda"
    sz = ep_sizes(reduced)
    cfg = ep_cfg(reduced)
    res = {}

    def check(ok, what):
        if not ok:
            raise AssertionError(f"ep: {what}")

    sh = [o["ep"]["shared"] for o in outs]
    worst = {a2a: max(s["max"][a2a] for s in sh) for a2a in ("binary", "xla")}
    print(f"ep: {cfg.name} at {depth(cfg)}, bf16, (1, 4): the MoE layer's ep output with the "
          f"shared expert ({sh[0]['shared_ff']} of its {sh[0]['whole_ff']} ff columns a rank) "
          f"on {sh[0]['tokens']} replicated tokens against the ep routed part plus the whole "
          f"shared MLP: worst row error over its RMS, binary exchange {worst['binary']:.3e}, "
          f"all_to_all_single {worst['xla']:.3e} (limit {EP_ROW_TOL}); a plant that adds only "
          f"the rank's ff share: worst {max(s['plant_max'] for s in sh):.3e}, rows within the "
          f"limit {min(s['plant_share'] for s in sh):.4f}")
    check(max(worst.values()) <= EP_ROW_TOL, f"shared expert rows {worst}")
    check(all(s["plant_max"] > EP_ROW_TOL for s in sh), "the plant passes the check")
    res["shared"] = worst
    ep, tp = outs[0]["ep"], outs[0]["tp"]
    rows = row_rel(torch, ep["h"], tp["h"])
    share = float(np.mean(rows <= EP_ROW_TOL))
    loss_rel = abs(ep["loss"] - tp["loss"]) / abs(tp["loss"])
    same_h = all(torch.equal(o["ep"]["h"], ep["h"]) and torch.equal(o["tp"]["h"], tp["h"])
                 for o in outs)
    print(f"ep: the forward at B=1, S={sz['seq']}, capacity factor {cfg.capacity_factor:g} "
          f"(no drops in either mode): hidden rows within {EP_ROW_TOL} of tp mode's "
          f"{share:.4f} (limit {EP_ROW_SHARE}; median row error {np.median(rows):.3e}, worst "
          f"{rows.max():.3e}), loss ep {ep['loss']:.5f} tp {tp['loss']:.5f} "
          f"({loss_rel:.2e}), the ranks' gathered rows equal: {same_h}; ms under the analysis "
          f"ep " + ", ".join(f"{o['ep']['fwd']['ms']:.0f}" for o in outs)
          + ", tp " + ", ".join(f"{o['tp']['fwd']['ms']:.0f}" for o in outs)
          + "; shards drawn in ep " + ", ".join(f"{o['ep']['draw_s']:.1f}" for o in outs)
          + " s, tp " + ", ".join(f"{o['tp']['draw_s']:.1f}" for o in outs)
          + f" s, {ep['model_bytes'] / 1e9:.3f} / {tp['model_bytes'] / 1e9:.3f} GB a rank, "
          f"peak allocated after the draw " + ", ".join(f"{o['ep']['peak_gb']:.2f}" for o in outs)
          + " GB by rank")
    check(same_h and share >= EP_ROW_SHARE and loss_rel <= PAR_TOL["bfloat16"],
          f"ep against tp: rows {share:.4f}, loss {loss_rel:.2e}, ranks agree {same_h}")
    res["row_share"], res["loss_rel"] = share, loss_rel
    steps = sz["prompt"] + sz["new"] - 1
    n_attn = attention_layers(cfg)
    agree = float(np.mean([np.mean(o["ep"]["dec"]["tokens"] == o["tp"]["dec"]["tokens"])
                           for o in outs]))
    prompt_agree = float(np.mean([np.mean(o["ep"]["dec"]["tokens"][:, :sz["prompt"]]
                                          == o["tp"]["dec"]["tokens"][:, :sz["prompt"]])
                                  for o in outs]))
    res["launches"] = {m: [o[m]["dec"]["launches"] for o in outs] for m in ("ep", "tp")}
    res["ms"] = {m: [o[m]["dec"]["ms"] for o in outs] for m in ("ep", "tp")}
    res["fwd_launches"] = [o["ep"]["fwd"]["launches"] for o in outs]
    print(f"ep: decode at (1, 4), {sz['lanes']} lanes ({sz['lanes'] // PAR_RANKS} tokens an ep "
          f"rank dispatches a step), {sz['prompt']} prompt + {sz['new']} new tokens: token "
          f"agreement with tp mode {agree:.4f} (prompt steps {prompt_agree:.4f}; limit "
          f"{EP_TOKEN_AGREEMENT}); ms a step by rank ep "
          + ", ".join(f"{v:.1f}" for v in res["ms"]["ep"]) + ", tp "
          + ", ".join(f"{v:.1f}" for v in res["ms"]["tp"])
          + f"; decode_attention launches by rank {res['launches']} (want {n_attn} x {steps}); "
          f"flash_attention launches of the forward {res['fwd_launches']}")
    check(agree >= EP_TOKEN_AGREEMENT, f"token agreement {agree:.4f}")
    if cuda:
        check(all(n == n_attn * steps for m in ("ep", "tp") for n in res["launches"][m]),
              f"decode launches {res['launches']}")
        check(all(n == n_attn for n in res["fwd_launches"]),
              f"forward launches {res['fwd_launches']}")
    res["agreement"] = agree
    for key, real_key, req_key, kernel in (("fwd", "fwd", "fwd_requested", "flash_attention"),
                                           ("dec", "dec_dry", "dec_requested",
                                            "decode_attention")):
        p = pred[key]
        pk = {k: v["calls"] for k, v in p["kernels"].items()}
        for o in outs:
            rec = o["ep"][real_key]["rec"]
            check(rec["cost"]["flops"] == p["cost"]["flops"]
                  and rec["collectives"] == p["collectives"] and rec["kernels"] == p["kernels"],
                  f"the dry run of the {key}: predicted {p['cost']}, {p['collectives']}, {pk}; "
                  f"real {rec['cost']}, {rec['collectives']}, {rec['kernels']}")
            if cuda:
                check(o["ep"][req_key] == p["memory"]["argument_bytes"],
                      f"the dry run of the {key}: setup requested {o['ep'][req_key]} bytes, "
                      f"predicted {p['memory']['argument_bytes']}")
                check({kernel: o["ep"][real_key]["launches"]} == pk,
                      f"the dry run of the {key}: launches {o['ep'][real_key]['launches']}, "
                      f"predicted {pk}")
        print(f"ep: the dry run of ep mode's {'forward and loss' if key == 'fwd' else 'decode step'}: "
              f"predicted argument bytes {p['memory']['argument_bytes']}, setup requested "
              + ", ".join(str(o["ep"][req_key]) for o in outs) + " by rank; FLOPs "
              f"{p['cost']['flops']:.6e}, collectives ("
              + ", ".join(f"{k} {int(v['count'])} x {v['bytes'] / 1e6:.3f} MB"
                          for k, v in p["collectives"].items())
              + f") and kernels {pk} equal on every rank; launches "
              + ", ".join(str(o["ep"][real_key]["launches"]) for o in outs)
              + f"; predicted temp {p['memory']['temp_bytes'] / 1e6:.3f} MB")
    res["dry"] = {k: {"argument_bytes": pred[k]["memory"]["argument_bytes"],
                      "kernels": {n: v["calls"] for n, v in pred[k]["kernels"].items()}}
                  for k in ("fwd", "dec")}
    f32 = [o["f32"] for o in outs]
    worst = max(f32, key=lambda f: f["grads"])
    print(f"ep: reduced {cfg.name.replace('-reduced', '')} in float32 (4 layers, 4 experts, "
          f"{f32[0]['experts_a_rank']} a rank), capacity factor {EP_REDUCED_CF:g}, (1, 4) ep "
          f"against the unsharded port: hidden {max(f['hidden'] for f in f32):.3e}, loss "
          f"{max(f['loss'] for f in f32):.3e}, worst of {f32[0]['n_grads']} gradients "
          f"{worst['grads']:.3e} ({worst['worst']}; the top-1 routers' against the largest "
          f"gradient entry {max(f['router'] for f in f32):.3e}; limit {PAR_TOL['float32']})")
    check(all(max(f["hidden"], f["loss"], f["grads"]) <= PAR_TOL["float32"] for f in f32),
          "float32 ep step against the unsharded port")
    res["f32"] = max(max(f["hidden"], f["loss"], f["grads"]) for f in f32)
    own = max(o["seconds"] for o in outs)
    res["seconds"] = own + time.perf_counter() - t0
    print(f"ep: phase 47 took {res['seconds']:.1f} s in phase 45's world (the ranks' own "
          f"{own:.1f} s)")
    return res


# phase 48: the recurrent configs served through ServeEngine, whose lane mask
# keeps each request's state its own: Mamba2-780m and RecurrentGemma-2B at
# full depth and width, bf16, 8 requests of 32 + 32 tokens at batch 8
# admitted staggered, two slots paused and resumed, a ninth request in the
# slot the first to finish leaves; every stream bit-identical to an engine
# that serves that request alone in the same slot
RSERVE = {"batch": 8, "requests": 8, "prompt": 32, "new": 32, "max_len": 128, "gap": 2,
          "pause": 4}
# Mamba2-780m's 48 layers take ~103 ms an engine step (4,100 small kernels,
# host-bound) and the phase runs ~1,000 steps a model: its depth is cut to
# keep the script inside its time; RecurrentGemma-2B keeps its 26 layers
RSERVE_LAYERS = {"mamba2": 12}
RSERVE_REDUCED = {"batch": 3, "requests": 3, "prompt": 5, "new": 8, "max_len": 32, "gap": 1,
                  "pause": 2}


def rserve_requests(cfg, sizes, seed=31):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, sizes["prompt"]).tolist(),
                    max_new=sizes["new"]) for i in range(sizes["requests"] + 1)]


def rserve_drive(eng, reqs, sizes):
    """``reqs`` through ``eng``: request i admitted after i * gap engine
    steps, the last two slots paused for ``pause`` steps after the last
    admission and resumed, the last request submitted into the slot that
    the first request to finish leaves.  Returns {rid: slot}."""
    n = sizes["requests"]
    lanes = {}

    def admit(r):
        if not eng.submit(r):
            raise AssertionError(f"request {r.rid} found no free slot")
        lanes[r.rid] = eng.slots.index(r)

    for r in reqs[:n]:
        admit(r)
        for _ in range(sizes["gap"]):
            eng.step()
    eng.set_capacity(eng.max_batch - 2)
    for _ in range(sizes["pause"]):
        eng.step()
    eng.set_capacity(eng.max_batch)
    while all(s is not None for s in eng.slots):
        eng.step()
    admit(reqs[n])
    if eng.run_until_done() or not all(r.done and len(r.out) == r.max_new for r in reqs):
        raise AssertionError("not every request finished with max_new tokens")
    return lanes


def rserve_alone(torch, cfg, model, req, lane, sizes, device):
    """``req``'s stream from a fresh engine that serves it alone in slot
    ``lane`` (the slots before it held by placeholders while it is
    submitted, so no other lane is prefilled)."""
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, model, max_batch=sizes["batch"], max_len=sizes["max_len"],
                      device=device)
    eng.slots[:lane] = [Request(-1, [0])] * lane
    r = Request(req.rid, list(req.prompt), max_new=req.max_new)
    if not eng.submit(r) or eng.slots.index(r) != lane:
        raise AssertionError(f"request {req.rid} did not take slot {lane}")
    eng.slots[:lane] = [None] * lane
    if eng.run_until_done():
        raise AssertionError(f"request {req.rid} did not finish alone")
    return r.out


def rserve_streams(torch, cfg, model, sizes, device, masked=True):
    """The drive's streams and slots, ms an engine step, decode steps and
    flash-decode launches (``masked=False``: the engine without its lane
    mask, as repro's advances every lane)."""
    from repro_torch import obs
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, model, max_batch=sizes["batch"], max_len=sizes["max_len"],
                      device=device)
    eng.masked = masked
    reqs = rserve_requests(cfg, sizes)
    obs.enable()
    obs.reset()
    decode_attention.launches = 0
    sync(torch, device)
    t0 = time.perf_counter()
    try:
        lanes = rserve_drive(eng, reqs, sizes)
        sync(torch, device)
        steps = obs.summary()["counters"]["serve.decode_steps"]
    finally:
        obs.disable()
        obs.reset()
    return {"streams": {r.rid: r.out for r in reqs}, "lanes": lanes, "steps": steps,
            "ms": (time.perf_counter() - t0) * 1e3 / steps,
            "launches": decode_attention.launches, "engine": eng}


def rserve_plant(torch, cfg, model, sizes, device, alone):
    """The drive's first two admissions (request 0, ``gap`` steps, request 1,
    ``gap`` steps) through the engine without its lane mask, which advances
    every lane at every step as repro's does: the requests whose tokens so
    far are not a prefix of their streams alone (request 1's prefill
    advances request 0's state)."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, model, max_batch=sizes["batch"], max_len=sizes["max_len"],
                      device=device)
    eng.masked = False
    reqs = rserve_requests(cfg, sizes)[:2]
    for r in reqs:
        if not eng.submit(r):
            raise AssertionError(f"request {r.rid} found no free slot")
        for _ in range(sizes["gap"]):
            eng.step()
    return [r.rid for r in reqs if r.out != alone[r.rid][:len(r.out)]]


def serve_recurrent(torch, cfg, sizes=RSERVE, device="cuda", model=None):
    """Phase 48 for one config (bf16 weights drawn on ``device`` from seed
    0 unless ``model`` is given): the drive, every request alone in its
    slot (streams bit-identical), the engine without the lane mask (must
    differ), launches a step, and a profile of engine steps."""
    from repro_torch.models import init_params

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if model is None:
        model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device,
                            dtype=torch.bfloat16)
    run = rserve_streams(torch, cfg, model, sizes, device)
    reqs = rserve_requests(cfg, sizes)
    alone = {r.rid: rserve_alone(torch, cfg, model, r, run["lanes"][r.rid], sizes, device)
             for r in reqs}
    same = [rid for rid in alone if alone[rid] == run["streams"][rid]]
    leaked = rserve_plant(torch, cfg, model, sizes, device, alone)
    n_attn = attention_layers(cfg)
    paused = [rid for rid, lane in run["lanes"].items() if lane >= sizes["batch"] - 2]
    reused = sizes["requests"]
    print(f"serve/recurrent: {cfg.name}, {depth(cfg)}, {next(model.parameters()).dtype}, "
          f"{sizes['requests']} requests of {sizes['prompt']} + {sizes['new']} tokens at batch "
          f"{sizes['batch']}, admitted every {sizes['gap']} engine steps, slots "
          f"{sizes['batch'] - 2}-{sizes['batch'] - 1} (requests {paused}) paused for "
          f"{sizes['pause']} steps, request {reused} in slot {run['lanes'][reused]} after its "
          f"last request: {len(same)} of {len(alone)} streams bit-identical to an engine "
          f"serving the request alone in its slot; the engine without the lane mask, through "
          f"the drive's first two admissions: the streams of requests {leaked} leave their "
          f"runs alone; "
          f"{run['steps']} decode steps, {run['ms']:.3f} ms a step; decode_attention "
          f"launches {run['launches']} = {n_attn} x {run['steps']}")
    if len(same) != len(alone):
        raise AssertionError(f"serve/recurrent: {cfg.name}: streams of requests "
                             f"{sorted(set(alone) - set(same))} differ from their runs alone")
    if not leaked:
        raise AssertionError(f"serve/recurrent: {cfg.name}: the engine without the lane "
                             f"mask passes the check")
    if device == "cuda" and run["launches"] != n_attn * run["steps"]:
        raise AssertionError(f"serve/recurrent: {cfg.name}: {run['launches']} decode_attention "
                             f"launches in {run['steps']} steps of {n_attn} attention layers")
    prof = profile_engine_steps(torch, run["engine"]) if device == "cuda" else None
    out = {"ms_per_step": run["ms"], "steps": run["steps"], "launches": run["launches"],
           "launches_per_step": run["launches"] / run["steps"],
           "idle_pct": prof["idle_pct"] if prof else None,
           "streams": run["streams"], "seconds": time.perf_counter() - t0}
    del model, run
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_recurrent_on_card(torch):
    """Phase 48: reduced Mamba-2 and RecurrentGemma in float32, the card's
    streams equal to the CPU's (plain versions) through the same drive;
    then Mamba2-780m and RecurrentGemma-2B (serve_recurrent)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    res = {}
    for arch in ("mamba2", "recurrentgemma"):
        cfg = get_arch(arch).reduced()
        model = init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                            dtype=torch.float32)
        streams = {dev: serve_recurrent(torch, cfg, RSERVE_REDUCED, dev,
                                        model.to(dev))["streams"] for dev in ("cpu", "cuda")}
        print(f"serve/recurrent: reduced {cfg.name}, float32: card streams equal the CPU's: "
              f"{streams['cpu'] == streams['cuda']}")
        if streams["cpu"] != streams["cuda"]:
            raise AssertionError(f"serve/recurrent: reduced {cfg.name}: card {streams['cuda']} "
                                 f"!= cpu {streams['cpu']}")
    for arch in ("mamba2", "recurrentgemma"):
        cfg = get_arch(arch)
        if arch in RSERVE_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=RSERVE_LAYERS[arch])
        res[arch] = serve_recurrent(torch, cfg)
    res["seconds"] = time.perf_counter() - t0
    print(f"serve/recurrent: phase 48 took {res['seconds']:.1f} s")
    return res


SLICES = 4                       # phase 42: slices of the one card
SLICE_SAMPLES = 131_072          # phase 42's counter sweep: 2 blocks of SWEEP_BLOCK
SLICE_CHECK_ROWS = 16_384


def slice_run(torch, label, rows, fn, launches_want, slices, warm=False):
    """One timed run of ``fn`` (after a warm-up unless ``warm``) and a
    profiled one: rows/s, the card's busy share and the prefix_scan
    launches of the timed run, which must be ``launches_want``."""
    from repro_torch.kernels.prefix_scan import prefix_scan

    if not warm:
        fn()
    sync(torch, "cuda")
    prefix_scan.launches = 0
    t0 = time.perf_counter()
    out = fn()
    sync(torch, "cuda")
    dt = time.perf_counter() - t0
    launches = prefix_scan.launches
    if launches != launches_want:
        raise AssertionError(f"slices {label}: prefix_scan launched {launches} times over "
                             f"{slices} slice(s), want {launches_want}")
    prof = device_share(torch, "cuda", f"{label}, {slices} slice(s)", fn)
    return out, {"seconds": dt, "rows_per_s": rows / dt, "launches": launches,
                 "busy_pct": 100 - prof["idle_pct"]}


def engines_over_slices(torch, fig17c, cost_bench):
    """Phase 42: the sweep, DCN and cost engines with the snapshot axis
    split into SLICES slices of the one card (``device=["cuda:0"] *
    SLICES``, a CUDA stream each) against the one-slice run (``"cuda:0"``):
    equal grids, rows/s, the card's busy share and prefix_scan launched by
    every slice."""
    from repro_torch.cost import run_cost_sweep
    from repro_torch.sim import CounterIIDSnapshots, ScenarioSpec, run_sweep

    devs = {1: "cuda:0", SLICES: ["cuda:0"] * SLICES}
    out = {"sweep": {}, "dcn": {}, "cost": {}}

    # the counter sweep of sweep_main_path's configuration, two blocks
    spec = ScenarioSpec(num_nodes=SWEEP_NODES,
                        snapshots=CounterIIDSnapshots(0.07, SLICE_SAMPLES, 5),
                        tp_sizes=(32,), architectures=("infinitehbd-k3", "nvl-72"))
    blocks = -(-SLICE_SAMPLES // SWEEP_BLOCK)
    grids = {}
    for n, dev in devs.items():
        grids[n], out["sweep"][n] = slice_run(
            torch, f"counter sweep {SLICE_SAMPLES} x {SWEEP_NODES}", SLICE_SAMPLES,
            lambda dev=dev: run_sweep(spec, backend="torch", chunk_snapshots=SWEEP_BLOCK,
                                      device=dev),
            sweep_scans(spec.models(), blocks) * n, n)
    for g in ("total_gpus", "faulty_gpus", "placed_gpus"):
        if not np.array_equal(getattr(grids[SLICES], g), getattr(grids[1], g)):
            raise AssertionError(f"slices: the {SLICES}-slice sweep's {g} differ from one "
                                 f"slice's")
    head = ScenarioSpec(num_nodes=SWEEP_NODES,
                        snapshots=CounterIIDSnapshots(0.07, SLICE_CHECK_ROWS, 5),
                        tp_sizes=(32,), architectures=("infinitehbd-k3", "nvl-72"))
    host = run_sweep(head, backend="numpy")
    if not (np.array_equal(grids[SLICES].placed_gpus[:, :SLICE_CHECK_ROWS], host.placed_gpus)
            and np.array_equal(grids[SLICES].faulty_gpus[:, :SLICE_CHECK_ROWS],
                               host.faulty_gpus)):
        raise AssertionError(f"slices: the first {SLICE_CHECK_ROWS} rows differ from numpy")
    del grids, host

    # the Fig. 17c grid (equal to numpy and BENCH_dcn.json inside; one
    # slice is phase 32's run on the one card)
    for n, fig in ((1, fig17c), (SLICES, check_fig17c(torch, devs[SLICES]))):
        _, out["dcn"][n] = slice_run(torch, "Fig. 17c DCN grid", fig["rows"], fig["run"],
                                     fig["launches"], n, warm=True)

    # benchmarks/cost.py's spec against cost_on_card's one-device grids
    cspec = cost_bench["spec"]
    rows = len(cspec.fault_ratios) * cspec.samples
    want = sweep_scans(cspec.models(), len(cspec.fault_ratios) * -(-cspec.samples // 1024))
    for n, dev in devs.items():
        got, out["cost"][n] = slice_run(
            torch, f"cost sweep at {cspec.num_nodes} nodes", rows,
            lambda dev=dev: run_cost_sweep(cspec, backend="torch", device=dev), want * n, n)
        if not cost_grids_equal(got, cost_bench["result"]):
            raise AssertionError(f"slices: the cost grids over {n} slice(s) differ from "
                                 f"cost_on_card's")
    for name, what in (("sweep", f"counter sweep, {SLICE_SAMPLES} snapshots x {SWEEP_NODES} "
                                 f"nodes, TP-32, blocks of {SWEEP_BLOCK}"),
                       ("dcn", "Fig. 17c DCN grid, 500 snapshots x 2048 nodes"),
                       ("cost", f"cost sweep, {rows} rows x {cspec.num_nodes} nodes")):
        one, many = out[name][1], out[name][SLICES]
        print(f"slices: {what}: {SLICES} slices of the card {many['rows_per_s']:.0f} rows/s "
              f"({many['seconds']:.3f} s, busy {many['busy_pct']:.1f}%, prefix_scan "
              f"{many['launches']}) against one slice {one['rows_per_s']:.0f} rows/s "
              f"({one['seconds']:.3f} s, busy {one['busy_pct']:.1f}%, prefix_scan "
              f"{one['launches']}): x{many['rows_per_s'] / one['rows_per_s']:.2f}; grids "
              f"equal")
    print(f"slices: the sweep's first {SLICE_CHECK_ROWS} rows equal numpy, the DCN grids "
          f"numpy and BENCH_dcn.json, the cost grids cost_on_card's one-device grids "
          f"({SLICES} slices share one card: not {SLICES} cards)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host's numpy references of phases 28, 30 and 33-36 need no card
    children = [Background("host_refs", "the host's numpy references")]
    try:
        return smoke(torch, children)
    finally:
        for child in children:
            child.close()


def smoke(torch, children) -> int:
    """The phases in order (``children``: the processes started beside them,
    the first the host's numpy references)."""
    refs = children[0]
    t_start = time.perf_counter()
    last = [t_start]

    def stage(label):
        now = time.perf_counter()
        print(f"stage: {label} took {now - last[0]:.1f} s ({now - t_start:.1f} s in all)")
        last[0] = now

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    build_kernels()
    # the SLO phase's control-plane replay, host code that launches
    # prefix_scan 4 times
    children.append(Background("slo_replay_to", "the SLO phase's replay"))
    stage("the build")
    errs = check_decode_attention(torch)
    stage("flash-decode's checks")
    flash_errs = check_flash_attention(torch)
    stage("flash-attention's checks")
    check_reduced_against_cpu(torch)
    launches = serve_full(torch)["launches"]
    stage("StarCoder2 served, reduced and full")
    times = {label: time_decode_attention(torch, label, s, top, slots)
             for label, s, top, slots in [("serve", 1024, 64, False),
                                          ("L=1024", 1024, None, False),
                                          ("L=4096", 4096, None, False),
                                          ("slots serve", 1024, 64, True),
                                          ("slots wrapped W=1024", 1024, None, True)]}
    lse_time = time_decode_attention(torch, "long_500k shard, slots wrapped", 32768, None, True,
                                     hq=3, hkv=1, d=128, b=1, lse=True)
    stage("flash-decode timed")
    train_reduced_against_cpu(torch)
    train = train_full(torch)
    stage("StarCoder2 trained, reduced and full")
    flash_times = time_flash_attention(torch)
    stage("flash-attention timed")

    from repro_torch.configs import get_arch

    last[0] = t_decoders = time.perf_counter()
    decoders_reduced_against_cpu(torch)
    danube = get_arch("h2o-danube")
    mixtral = dataclasses.replace(get_arch("mixtral"), num_layers=MIXTRAL_LAYERS)
    llama4 = dataclasses.replace(get_arch("llama4"), num_layers=2)
    decoder_runs = {
        "h2o_danube_train": train_full(torch, danube, seq=8192),
        "h2o_danube_serve": serve_full(torch, danube),
        "mixtral_train": train_full(torch, mixtral, seq=8192),
        "mixtral_serve": serve_full(torch, mixtral),
        "llama4_serve": serve_full(torch, llama4),
    }
    decoders_s = time.perf_counter() - t_decoders
    print(f"decoders: the decoder-config phases (reduced H2O-Danube, Mixtral and "
          f"Llama-4 against the CPU; H2O-Danube-1.8B trained and served; Mixtral-8x7B "
          f"at {MIXTRAL_LAYERS} layers trained and served; Llama-4 Maverick at 2 layers "
          f"served) took {decoders_s:.1f} s")

    t_vlm = time.perf_counter()
    vlm_flash_errs = check_vlm_encdec_flash(torch)
    d256_errs = check_d256_flash(torch)
    f32_errs = check_f32_flash(torch)
    vlm_decode_err = check_vlm_encdec_decode(torch)
    decoders_reduced_against_cpu(torch, ("paligemma", "whisper"))
    paligemma, whisper = get_arch("paligemma"), get_arch("whisper")
    vlm_runs = {
        "paligemma_train": train_full(torch, paligemma, batch=1, seq=4096),
        "paligemma_serve": serve_full(torch, paligemma),
        "whisper_train": train_full(torch, whisper, batch=16, seq=448),
        "whisper_serve": serve_full(torch, whisper),
    }
    vlm_times = {
        "paligemma_prefix_d256_bf16": time_flash_attention(
            torch, "PaliGemma prefix-LM", 1, 4096, 4096, 8, 1, 256, "bfloat16",
            dict(causal=True, prefix_len=256)),
        "whisper_encoder_f32": time_flash_attention(
            torch, "Whisper encoder", 16, 1500, 1500, 12, 12, 64, "float32",
            dict(causal=False)),
        "whisper_cross_f32": time_flash_attention(
            torch, "Whisper cross-attention", 16, 448, 1500, 12, 12, 64, "float32",
            dict(causal=False)),
    }
    vlm_s = time.perf_counter() - t_vlm
    print(f"vlm/encdec: the PaliGemma and Whisper phases (flash and flash-decode at their "
          f"shapes, reduced models against the CPU, PaliGemma-3B and Whisper-small trained "
          f"and served, flash timed at their shapes) took {vlm_s:.1f} s")

    t_rg = time.perf_counter()
    rg_errs = check_recurrentgemma_kernels(torch)
    recurrentgemma_reduced_against_cpu(torch)
    recurrentgemma = get_arch("recurrentgemma")
    rg_runs = {"train": train_full(torch, recurrentgemma, batch=1, seq=4096),
               "decode": decode_lockstep(torch, recurrentgemma)}
    label, b, sq, sk, hq, hkv, d, kw = RECURRENTGEMMA_FLASH
    rg_times = {
        "recurrentgemma_window2048_d256_bf16": time_flash_attention(
            torch, label, b, sq, sk, hq, hkv, d, "bfloat16", kw),
        "recurrentgemma_causal_d256_bf16": time_flash_attention(
            torch, "RecurrentGemma shape, causal only", b, sq, sk, hq, hkv, d, "bfloat16",
            dict(causal=True)),
    }
    for name, t in (("PaliGemma-3B", vlm_times["paligemma_prefix_d256_bf16"]),
                    ("RecurrentGemma-2B", rg_times["recurrentgemma_window2048_d256_bf16"])):
        print(f"time flash_attention D=256 bf16 at {name}'s training shape: " + "; ".join(
            f"{p} {t[p]['ms']:.3f} ms (bound {t[p]['bound_ms']:.3f}, plain {t[p]['plain_ms']:.3f}, "
            f"sdpa {t[p]['library_ms']:.3f})" for p in ("fwd", "bwd"))
            + f"; backward's dK/dV {t['bwd dK/dV']['ms']:.3f} ms, dQ {t['bwd dQ']['ms']:.3f} ms")
    kept = sum(min(i + 1, kw["window"]) for i in range(sq)) / (sq * (sq + 1) // 2)
    for pas in ("fwd", "bwd"):
        win, full = (rg_times[k][pas]["ms"] for k in rg_times)
        print(f"time flash_attention {pas} RecurrentGemma shape: window {kw['window']} / "
              f"causal {win:.3f} / {full:.3f} ms = {win / full:.3f} (the window keeps "
              f"{kept:.4f} of the causal pairs)")
    dc = RECURRENTGEMMA_DECODE
    rg_decode_time = time_decode_attention(torch, "RecurrentGemma slots wrapped W=2048",
                                           dc["w"], None, True, dc["hq"], dc["hkv"], dc["d"],
                                           window=dc["w"])
    rg_s = time.perf_counter() - t_rg
    print(f"recurrentgemma: the RecurrentGemma phases (flash and flash-decode at its shapes, "
          f"the reduced model against the CPU, RecurrentGemma-2B trained and decoded in "
          f"lockstep, flash and flash-decode timed at its shapes) took {rg_s:.1f} s")
    last[0] = time.perf_counter()
    ssd_errs = check_ssd_scan(torch)
    train_mamba_reduced_against_cpu(torch)
    mamba = train_mamba_full(torch)
    decode_lockstep(torch)
    ssd_times = time_ssd_scan(torch)
    stage("the Mamba-2 phases")
    t_check = time.perf_counter()
    scan_err = check_prefix_scan(torch)
    scan_check_s = time.perf_counter() - t_check
    stage("prefix_scan's checks")
    hists = {}

    def counted(phase, fn, *args, elsewhere=None, **kw):
        """fn's result, its prefix_scan launches counted by (rows, length,
        route) under ``phase``, with ``elsewhere``'s counts (launches of the
        phase made in another process)."""
        with ScanHistogram() as h:
            out = fn(*args, **kw)
        h.add(elsewhere or {})
        hists[phase] = h
        print(h.line(phase))
        return out

    counted("phase 28 (the zoo)", check_sweep_zoo, torch, refs)
    stage("the zoo")
    counted("phase 29 (Fig. 13)", check_fig13, torch)
    sweep = counted("phase 30 (the sweep's main path)", sweep_main_path, torch, refs=refs)
    t_times = time.perf_counter()
    scan_times = time_prefix_scan(torch)
    stage("Fig. 13, the sweep's main path and prefix_scan timed")
    t_dcn = time.perf_counter()
    fig17c = counted("phase 32 (Fig. 17c)", check_fig17c, torch)
    dc = counted("phase 33 (DCN at 8192 nodes)", dcn_datacenter, torch, refs)
    t_short = time.perf_counter()
    short_rows = time_short_row_scans(torch)
    times_s = t_dcn - t_times + time.perf_counter() - t_short
    churn = counted("phase 34 (churn)", churn_on_card, torch, refs)
    dcn_s = time.perf_counter() - t_dcn
    print(f"dcn/churn: the DCN and churn phases (the Fig. 17c grid, the 8192-node placement, "
          f"the short-row scans, the churn ensemble, the traffic and control-plane replays) "
          f"took {dcn_s:.1f} s")
    t_engines = time.perf_counter()
    cost = counted("phase 35 (cost)", cost_on_card, torch, refs=refs)
    matrix = counted("phase 36 (matrix)", matrix_on_card, torch, refs=refs)
    replay = children[1].get()
    slo = counted("phase 37 (SLO, with its replay's process)", slo_on_card, torch,
                  replay=replay, elsewhere=replay[4])
    faults = counted("phase 38 (faults)", faults_on_card, torch)
    engines_s = time.perf_counter() - t_engines
    print(f"cost/matrix/slo/faults: the cost, comparison-matrix, serving-SLO and fault "
          f"phases took {engines_s:.1f} s")
    t_par = time.perf_counter()
    par = parallel_on_card(torch)
    elastic = elastic_on_card(torch)
    par_s = time.perf_counter() - t_par
    print(f"parallel/elastic: the collectives, sharded Mixtral and elastic phases (39-41) "
          f"took {par_s:.1f} s")
    t_spf = time.perf_counter()
    slices = counted("phase 42 (4 slices)", engines_over_slices, torch, fig17c, cost["bench"])
    every = ScanHistogram()
    for h in hists.values():
        every.add(h.counts)
    print(every.line("phases 28-38 and 42"))
    print(f"prefix_scan: its checks took {scan_check_s:.1f} s, the three shapes' timing "
          f"{times_s:.1f} s")
    slices_s = time.perf_counter() - t_spf
    spf = sp_fsdp_on_card(torch)
    spf_s = time.perf_counter() - t_spf
    print(f"slices/sp/fsdp: phases 42-43 took {spf_s:.1f} s (phase 42 {slices_s:.1f} s)")
    t_dry = time.perf_counter()
    with tempfile.TemporaryDirectory() as cells_dir:
        # the production cells' dry run needs no card: it runs beside phase 44
        cells = subprocess.Popen(_child(f"dry_cells({cells_dir!r})"), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            recurrent = recurrent_on_card(torch)
            dry = dryrun_on_card(torch, cells=cells, decode=True, ep=True)
        finally:
            if cells.poll() is None:
                cells.kill()
                cells.communicate()
    dry_s = time.perf_counter() - t_dry
    dec, ep = dry["decode"], dry["ep"]
    print(f"recurrent/dryrun/decode/ep: phases 44-47 took {dry_s:.1f} s (phase 46 "
          f"{dec['seconds']:.1f} s, phase 47 {ep['seconds']:.1f} s)")
    rserve = serve_recurrent_on_card(torch)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, of which the "
          f"decoder-config phases {decoders_s:.1f} s, the PaliGemma and Whisper phases "
          f"{vlm_s:.1f} s, the RecurrentGemma phases {rg_s:.1f} s, the DCN and churn "
          f"phases {dcn_s:.1f} s, the cost, matrix, SLO and fault phases {engines_s:.1f} s, "
          f"the parallel and elastic phases {par_s:.1f} s, the slices, SP and FSDP "
          f"phases {spf_s:.1f} s, the recurrent, dry-run, decode-under-a-mesh and ep phases "
          f"{dry_s:.1f} s (phase 46 {dec['seconds']:.1f} s, phase 47 {ep['seconds']:.1f} s) "
          f"and the recurrent serving phase {rserve['seconds']:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:65",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_err_bf16": errs["bfloat16"],
        "max_err_f32": errs["float32"],
        "max_err_slots": errs["slots"],
        "shape": "B=8 Hq=24 Hkv=2 D=128 S=L=1024 bf16",
        **times["L=1024"],
        "serve_shape": times["serve"],
        "L4096": times["L=4096"],
        "slots_serve_shape": times["slots serve"],
        "slots_wrapped_W1024": times["slots wrapped W=1024"],
        "launches_h2o_danube_serve": decoder_runs["h2o_danube_serve"]["launches"],
        "launches_mixtral_serve": decoder_runs["mixtral_serve"]["launches"],
        "launches_llama4_serve": decoder_runs["llama4_serve"]["launches"],
        "launches_paligemma_serve": vlm_runs["paligemma_serve"]["launches"],
        "launches_whisper_serve": vlm_runs["whisper_serve"]["launches"],
        "launches_recurrentgemma_decode": rg_runs["decode"]["launches"],
        "max_err_model_shapes": max(vlm_decode_err, rg_errs["decode"]),
        "recurrentgemma_slots_wrapped_W2048": rg_decode_time,
        "max_err_lse": errs["lse"],
        "lse_long_500k_shard": {**lse_time,
                                "shape": "B=1 Hq=3 Hkv=1 D=128 S=32768 bf16, out f32 + lse"},
        "launches_sharded_decode_per_rank": dec["launches"],
        "sharded_decode_ms_per_step_per_rank": dec["ms"],
        "sharded_decode_merge_ms_per_step_per_rank": dec["merge_ms"],
        "launches_dryrun_decode_step": dec["dry"]["kernels"],
        "launches_llama4_ep_decode_per_rank": ep["launches"]["ep"],
        "launches_llama4_tp_decode_per_rank": ep["launches"]["tp"],
        "llama4_ep_decode_ms_per_step_per_rank": ep["ms"]["ep"],
        "launches_dryrun_llama4_ep_decode_step": ep["dry"]["dec"]["kernels"],
        "launches_recurrentgemma_serve": rserve["recurrentgemma"]["launches"],
        "launches_mamba2_serve": rserve["mamba2"]["launches"],
        "recurrent_serve_ms_per_step": {k: rserve[k]["ms_per_step"]
                                        for k in ("mamba2", "recurrentgemma")},
        "recurrent_serve_idle_pct": {k: rserve[k]["idle_pct"]
                                     for k in ("mamba2", "recurrentgemma")},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:96",
        "launches": train["fwd"],
        "max_abs_err": flash_errs["fwd"],
        "shape": "B=1 S=4096 Hq=24 Hkv=2 D=128 bf16 causal",
        **flash_times["fwd"],
        "launches_h2o_danube_train": decoder_runs["h2o_danube_train"]["fwd"],
        "launches_mixtral_train": decoder_runs["mixtral_train"]["fwd"],
        "launches_paligemma_train": vlm_runs["paligemma_train"]["fwd"],
        "launches_whisper_train": vlm_runs["whisper_train"]["fwd"],
        "launches_recurrentgemma_train": rg_runs["train"]["fwd"],
        "max_err_model_shapes": max(vlm_flash_errs["fwd"], rg_errs["fwd"]),
        "max_err_d256_cases": d256_errs["fwd"],
        "max_err_f32_cases": f32_errs["fwd"],
        **{key: t["fwd"] for key, t in {**vlm_times, **rg_times}.items()},
        "launches_mixtral_sharded_step_per_rank": [l["fwd"] for l in par["launches"]],
        "launches_elastic_restart": elastic["fault_launches"],
        "launches_starcoder2_sp_fsdp_step_per_rank": {
            k: [l["fwd"] for l in v["launches"]] for k, v in spf["runs"].items()},
        "launches_recurrentgemma_sharded_step_per_rank": [
            l["flash_attention"] for l in recurrent["recurrentgemma"]["launches"]],
        "launches_dryrun_step_per_rank": {
            k: [l["flash_attention"] for l in v["launches"]] for k, v in dry["runs"].items()},
        "launches_llama4_ep_forward_per_rank": ep["fwd_launches"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/models/layers.py:155",
        "launches": train["bwd"],
        "max_abs_err": flash_errs["bwd"],
        "shape": "B=1 S=4096 Hq=24 Hkv=2 D=128 bf16 causal",
        **flash_times["bwd"],
        "launches_h2o_danube_train": decoder_runs["h2o_danube_train"]["bwd"],
        "launches_mixtral_train": decoder_runs["mixtral_train"]["bwd"],
        "launches_paligemma_train": vlm_runs["paligemma_train"]["bwd"],
        "launches_whisper_train": vlm_runs["whisper_train"]["bwd"],
        "launches_recurrentgemma_train": rg_runs["train"]["bwd"],
        "max_err_model_shapes": max(vlm_flash_errs["bwd"], rg_errs["bwd"]),
        "max_err_d256_cases": d256_errs["bwd"],
        "max_err_f32_cases": f32_errs["bwd"],
        **{key: t["bwd"] for key, t in {**vlm_times, **rg_times}.items()},
        "passes": {k: {"ms": v["ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"]}
                   for k, v in flash_times.items() if k.startswith("bwd ")},
        "launches_mixtral_sharded_step_per_rank": [l["bwd"] for l in par["launches"]],
        "launches_starcoder2_sp_fsdp_step_per_rank": {
            k: [l["bwd"] for l in v["launches"]] for k, v in spf["runs"].items()},
        "launches_recurrentgemma_sharded_step_per_rank": [
            l["flash_attention_bwd"] for l in recurrent["recurrentgemma"]["launches"]],
        "launches_dryrun_step_per_rank": {
            k: [l["flash_attention_bwd"] for l in v["launches"]]
            for k, v in dry["runs"].items()},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:72",
        "launches": mamba["fwd"],
        "max_abs_err": ssd_errs["fwd"],
        "shape": "Bt=4 S=4096 H=48 P=64 N=128 chunk=128, x/B/C bf16, y f32",
        **ssd_times["fwd"],
        "launches_mamba2_sharded_step_per_rank": [
            l["ssd_scan"] for l in recurrent["mamba2"]["launches"]],
        "heads_per_launch_sharded": recurrent["mamba2"]["local"]["heads"],
    }, {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/models/ssm.py:29",
        "launches": mamba["bwd"],
        "max_abs_err": ssd_errs["bwd"],
        "shape": "Bt=4 S=4096 H=48 P=64 N=128 chunk=128, x/B/C bf16, dy f32",
        **ssd_times["bwd"],
        "launches_mamba2_sharded_step_per_rank": [
            l["ssd_scan_bwd"] for l in recurrent["mamba2"]["launches"]],
        "heads_per_launch_sharded": recurrent["mamba2"]["local"]["heads"],
    }, {
        "name": "prefix_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/prefix_scan.cu",
        "replaces": "src/repro/kernels/prefix_scan/prefix_scan.py:41",
        "launches": sweep["launches"],
        "max_abs_err": scan_err,
        "plain": "torch.cumsum of the int32 cast (a library call)",
        "library": "torch.cumsum(mask, -1, dtype=torch.int32)",
        **scan_times,
        "shape": f"({SWEEP_BLOCK}, {SWEEP_NODES}) bool -> int32",
        "sweep_snaps_per_s": sweep["snaps_per_s"],
        "launches_dcn_fig17c": fig17c["launches"],
        "launches_dcn_8192": dc["launches"],
        "launches_churn_batched": churn["batched"]["launches"],
        "launches_churn_streamed": churn["streamed"]["launches"],
        "launches_traffic_replay": churn["traffic"]["launches"],
        "dcn_8192_rows_per_s": {str(tp): v["rows_per_s"] for tp, v in dc["per_tp"].items()},
        "dcn_8192_scan_bound_ms": dc["scan_bound_ms"],
        "dcn_short_rows": short_rows,
        "launch_histogram": {phase: h.rows() for phase, h in hists.items()},
        "launches_cost_bench": cost["bench"]["launches"],
        "launches_cost_8192": cost["8192"]["launches"],
        "launches_matrix_bench": matrix["bench"]["launches"],
        "launches_matrix_8192": matrix["8192"]["launches"],
        "launches_slo_replay": slo["replay_launches"],
        "launches_faults_rebuild": faults["launches"],
        "cost_8192_rows_per_s": cost["8192"]["rows_per_s"],
        "matrix_8192_seconds": matrix["8192"]["seconds"],
        "slo_scan_requests_per_s": {k: slo[k]["requests_per_s"] for k in ("bench", "2048")},
        **{f"launches_{name}_{n}_slices": v["launches"]
           for name, per in slices.items() for n, v in per.items()},
        **{f"{name}_{n}_slices_rows_per_s": v["rows_per_s"]
           for name, per in slices.items() for n, v in per.items()},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
