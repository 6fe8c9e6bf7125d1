"""Time the phases of flash-decode's blocks on the card.

The kernel source ``csrc/decode_attention.cu`` built with
``-DDECODE_ATTENTION_STAMPS`` (by this script, into a temporary directory;
the library the port loads has no stamps) makes each block's thread 0 read
the globaltimer at its phase boundaries: 0 start, 1 keys marked (the
census), 2 first tiles' loads issued, 3 first tile landed, 4 keys
streamed, 5 partial ready (before the merge), 6 first ticket taken (merge
through device memory), 7 group merged, 8 output written, and inside the
block's last merge through memory 9 the partials' (m, l) landed
("landed"), 10 their acc landed and the weights taken ("weighed"), 11
columns summed.  For the shapes ``chip_smoke.py`` times (StarCoder2 heads
at B=8 over L=1024 and 4096 and a wrapped W=1024 ring, RecurrentGemma-2B's
wrapped 2048-slot ring, long_500k's shard in the log-sum-exp form) it
launches the stamped kernel ``LAUNCHES`` times through the port's wrapper
and prints, for the launch of median span, each stamp's spread over the
blocks (min, median, max µs after the first block's start) and the median
over blocks of each step between a block's consecutive stamps, in time
order.  Needs a
CUDA card and nvcc; prints the card's name and power limit, then one JSON
line a shape.  SOURCE, if given, is another copy of the kernel source to
stamp (a patched probe)::

    python3 tools/decode_attention_phases.py [SOURCE]
"""

from __future__ import annotations

import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

STAMPS = ["start", "marked", "issued", "tile0", "streamed", "partial", "ticket", "group",
          "out", "landed", "weighed", "summed"]
LAUNCHES = 11


def build(tmp: Path, source: Path | None = None) -> ctypes.CDLL:
    """The stamped library of ``source`` (the package's kernel source by
    default), built into ``tmp``."""
    from repro_torch.kernels import _build

    out = tmp / "decode_attention_stamps.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DDECODE_ATTENTION_STAMPS", "-o", str(out),
           str(source or _build.CSRC / "decode_attention.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.decode_attention_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.decode_attention_stamps.restype = ctypes.c_int
    return lib


def phases(stamps) -> dict:
    """Each stamp's (min, median, max) µs over the blocks that wrote it,
    from the first start, the median µs of each step between a block's
    consecutive stamps in time order, and the span."""
    t0 = min(row[0] for row in stamps if row[0])
    spread, steps = {}, {}
    for k, name in enumerate(STAMPS):
        ts = sorted((row[k] - t0) / 1e3 for row in stamps if row[k])
        if ts:
            spread[name] = [round(ts[0], 2), round(statistics.median(ts), 2), round(ts[-1], 2)]
    for row in stamps:
        have = sorted((row[k], k) for k in range(len(STAMPS)) if row[k])
        for (ta, a), (tb, b) in zip(have, have[1:]):
            steps.setdefault(f"{STAMPS[a]}->{STAMPS[b]}", []).append((tb - ta) / 1e3)
    end = max(max(row) for row in stamps)
    return {"blocks": len(stamps), "span_us": round((end - t0) / 1e3, 3), "stamps": spread,
            "steps_us": {k: round(statistics.median(v), 2) for k, v in steps.items()}}


def shapes():
    """(label, S, max_len, slots, b, hq, hkv, d, window, lse) of the shapes
    ``chip_smoke.py`` times."""
    import chip_smoke as C

    dc = C.RECURRENTGEMMA_DECODE
    return [
        ("L=1024", 1024, None, False, 8, 24, 2, 128, 0, False),
        ("L=4096", 4096, None, False, 8, 24, 2, 128, 0, False),
        ("slots wrapped W=1024", 1024, None, True, 8, 24, 2, 128, 0, False),
        ("recurrentgemma slots wrapped W=2048", dc["w"], None, True, dc["b"], dc["hq"],
         dc["hkv"], dc["d"], dc["w"], False),
        ("long_500k shard lse", 32768, None, True, 1, 3, 1, 128, 0, True),
    ]


def measure(torch, W, lib, shape) -> dict:
    """The stamped kernel (``lib``) through the wrapper module ``W`` at one
    shape: the launch of median span, with every launch's span."""
    import chip_smoke as C

    label, s, top, slots, b, hq, hkv, d, window, lse = shape
    bufs = C.decode_bufs(torch, s, top, slots, b, hq, hkv, d)
    pl = W.plan(b, hq, hkv, s, torch.cuda.get_device_properties(0).multi_processor_count)
    blocks = pl.units * pl.n_split
    buf = torch.zeros((blocks, len(STAMPS)), dtype=torch.int64, device="cuda")
    W._lib = lambda: lib
    if lib.decode_attention_stamps(buf.data_ptr(), blocks):
        raise RuntimeError("decode_attention_stamps failed")
    runs = []
    for i in range(LAUNCHES):
        buf.zero_()
        if slots:
            W.decode_attention_cache(*bufs[i % len(bufs)], window=window, return_lse=lse)
        else:
            W.decode_attention(*bufs[i % len(bufs)])
        torch.cuda.synchronize()
        runs.append(phases(buf.cpu().tolist()))
    lib.decode_attention_stamps(None, 0)
    runs.sort(key=lambda r: r["span_us"])
    return {"shape": label, "n_split": pl.n_split, "merge": pl.merge, "group": pl.group,
            "spans_us": [r["span_us"] for r in runs], **runs[len(runs) // 2]}


def main(args) -> int:
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("decode_attention_phases: no CUDA card", file=sys.stderr)
        return 1
    W = importlib.import_module("repro_torch.kernels.decode_attention.decode_attention")
    print(C.card_line())
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp), Path(args[0]) if args else None)
        for shape in shapes():
            print(json.dumps(measure(torch, W, lib, shape)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
