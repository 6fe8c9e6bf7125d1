"""Time the prefix-scan kernel's routes, and checkouts against each other.

    python3 tools/prefix_scan_bench.py routes
    python3 tools/prefix_scan_bench.py ab DIR [DIR ...]

``routes`` builds this checkout's ``csrc/prefix_scan.cu``, holds every
route (the warp route at each team width, the block route, vector and
element access, small and persistent grids) bit-equal to ``torch.cumsum``
on ragged shapes, then times each route at the engines' shapes: the DCN
tier carve (131072, 64), its residual carve (1024, 8192), the sweep's
(65536, 10000) block and a grid of lengths and row counts around the
routes' thresholds.  One JSON line a shape: the route ``scan_route``
picks and the device ms of each variant.

``ab`` runs, for each DIR (a checkout of this repository) in a fresh
interpreter on that checkout's ``src/``, the three shapes above through its
``prefix_scan`` and the DCN placement at 8192 nodes (512-node domains, the
five fault ratios x 1024 snapshots, TP 32 and 64; ``chip_smoke.py`` phase
33): rows/s per TP (three runs each), and one TP-32 run under torch.profiler with the prefix
scans' share of the device's busy time.  Giving ``parent change change
parent`` brackets drift of the card.  One JSON line a run.

Times are by CUDA graph: 20 calls over 4 distinct inputs (more bytes than
the 50 MB L2) replayed between CUDA events, the median of 7 replays; the
profiler's device time per call beside it.  Needs a CUDA card and nvcc;
prints the card's name and power limit first.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
SHAPES = {"tier": (131072, 64), "residual": (1024, 8192), "sweep": (65536, 10000)}


def graph_ms(torch, fn, n_buf, iters=20, repeats=7):
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


def profiler_ms(torch, fn, n_buf, substring="prefix_scan", calls=8):
    """Device ms per call of the kernels whose names hold ``substring``."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i % n_buf)
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and substring in e.name) / 1e3 / calls


def inputs(torch, shape, dtype=None, n=4, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype is None or dtype == torch.bool:
        return [torch.rand(shape, generator=gen, device="cuda") < 0.07 for _ in range(n)]
    return [torch.randint(0, 1 << 10, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(dtype) for _ in range(n)]


def check_routes(torch, ps):
    """Every route variant bit-equal to torch.cumsum on ragged shapes."""
    cases = 0
    for rows, length in [(1, 1), (7, 3), (131, 17), (1000, 64), (33, 129), (5, 1030),
                         (131, 4099), (3, 8193), (2000, 200)]:
        for dtype in (torch.bool, torch.uint8, torch.int32):
            base = inputs(torch, (rows * length + 1,), dtype, n=1, seed=rows + length)[0]
            for x in (base[:-1].view(rows, length), base[1:].view(rows, length)):
                want = torch.cumsum(x.to(torch.int32), -1, dtype=torch.int32)
                aligned = x.data_ptr() % (16 if dtype == torch.int32 else 4) == 0
                vec = aligned and length % ps.ITEMS == 0
                variants = [ps.ScanRoute("warp", lanes, vec, grid)
                            for lanes in (1, 2, 4, 8, 16, 32) for grid in (1, 3, 1056)]
                variants += [ps.ScanRoute("block", 0, vec, grid) for grid in (1, 2, 1056)]
                for route in variants:
                    out = torch.empty_like(want)
                    ps.launch(x, out, route)
                    if not torch.equal(out, want):
                        raise AssertionError(f"{route} differs at ({rows}, {length}) {dtype}")
                    cases += 1
    torch.cuda.synchronize()
    print(f"routes: {cases} forced-route cases bit-equal to torch.cumsum")


def time_variants(torch, ps, label, shape, dtype=None):
    dtype = dtype or torch.bool
    xs = inputs(torch, shape, dtype)
    rows, length = shape
    kind = 0 if dtype != torch.int32 else 1
    auto = ps.route_of(xs[0])
    lanes = auto.lanes or 32                  # the block route's rows take 32 lanes
    warps = -(-rows // (32 // lanes))
    sms = ps._sms(0)
    variants = {"auto": auto}
    for per_sm in (2, 3, 4, 8):
        variants[f"warp_grid{per_sm}"] = ps.ScanRoute("warp", lanes, auto.vec,
                                                      min(-(-warps // 8), sms * per_sm))
        variants[f"block_grid{per_sm}"] = ps.ScanRoute("block", 0, auto.vec,
                                                       min(rows, sms * per_sm))
    outs = [torch.empty(shape, dtype=torch.int32, device="cuda") for _ in xs]
    want = torch.cumsum(xs[0].to(torch.int32), -1, dtype=torch.int32)
    res = {"label": label, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "route": auto._asdict(),
           "bound_ms": rows * length * (5 if kind == 0 else 8) / HBM_BYTES_PER_S * 1e3}
    for name, route in variants.items():
        ps.launch(xs[0], outs[0], route)
        if not torch.equal(outs[0], want):
            raise AssertionError(f"{label} {name} {route} differs from torch.cumsum")
        res[name] = graph_ms(torch, lambda i, r=route: ps.launch(xs[i], outs[i], r), len(xs))
    res["torch_cumsum"] = graph_ms(
        torch, lambda i: torch.cumsum(xs[i], -1, dtype=torch.int32), len(xs))
    print(json.dumps(res))


def routes_main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch

    from repro_torch.kernels import _build

    ps = importlib.import_module("repro_torch.kernels.prefix_scan.prefix_scan")
    report = _build.build(["prefix_scan"]).get("prefix_scan", "(built before)")
    print("\n".join(line for line in report.splitlines()
                    if "entry function" in line or "Used" in line or "spill" in line))
    check_routes(torch, ps)
    for label, shape in SHAPES.items():
        time_variants(torch, ps, label, shape)
    for label in ("tier", "residual"):
        time_variants(torch, ps, label + " int32", SHAPES[label], torch.int32)
    for length in (200, 256, 400, 512, 720, 768, 1024, 2048, 4096, 8192, 10000):
        for rows in (256, 1024, 4096, 16384, 65536):
            if rows * length <= 1 << 28:
                time_variants(torch, ps, "grid", (rows, length))
    return 0


RUN = """
import json, statistics, sys, time
sys.path.insert(0, {src!r})
sys.path.insert(0, {tools!r})
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import prefix_scan_bench as B
from repro_torch.kernels import _build
from repro_torch.kernels.prefix_scan import prefix_scan
from repro_torch.dcn import DcnSpec
from repro_torch.dcn.torch_backend import fat_tree_placements
_build.build(["prefix_scan"])
out = {{"shapes": {{}}, "dcn": {{}}}}
for label, shape in B.SHAPES.items():
    xs = B.inputs(torch, shape)
    keep = [None] * len(xs)
    def call(i):
        keep[i] = prefix_scan(xs[i])
    out["shapes"][label] = {{"ms": B.graph_ms(torch, call, len(xs)),
                            "profiler_ms": B.profiler_ms(torch, call, len(xs))}}
    del xs, keep
spec = DcnSpec(num_nodes=8192, agg_domain=512, fault_ratios=(0.0, 0.03, 0.05, 0.07, 0.10),
               samples=1024, tp_sizes=(32, 64), job_scale=0.85, seed=3,
               variants=("orchestrated",))
stacked = np.concatenate([spec.masks(ri) for ri in range(5)])
for tp in (32, 64):
    job = spec.job_gpus(tp)
    fat_tree_placements(stacked[:1024], spec.config, [tp], [job], chunk_snapshots=1024)
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fat_tree_placements(stacked, spec.config, [tp], [job], chunk_snapshots=1024)
        torch.cuda.synchronize()
        rates.append(len(stacked) / (time.perf_counter() - t0))
    out["dcn"][tp] = {{"rows_per_s": rates}}
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fat_tree_placements(stacked, spec.config, [32], [spec.job_gpus(32)], chunk_snapshots=1024)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
busy = sum(e.time_range.end - e.time_range.start for e in ev) / 1e3
scan = sum(e.time_range.end - e.time_range.start for e in ev if "prefix_scan" in e.name) / 1e3
out["dcn"]["profile_tp32"] = {{"wall_ms": wall, "busy_ms": busy, "scan_ms": scan,
                              "scan_launches": sum("prefix_scan" in e.name for e in ev)}}
print(json.dumps(out))
"""


def ab_main(dirs) -> int:
    tools = str(Path(__file__).resolve().parent)
    for root in dirs:
        src = str(Path(root).resolve() / "src")
        out = subprocess.run([sys.executable, "-c", RUN.format(src=src, tools=tools)],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(json.dumps({"dir": root, **json.loads(out.stdout.strip().splitlines()[-1])}))
    return 0


def main(argv) -> int:
    if not argv or argv[0] not in ("routes", "ab") or (argv[0] == "ab" and len(argv) < 2):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return routes_main() if argv[0] == "routes" else ab_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
