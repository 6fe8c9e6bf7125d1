"""Time flash-decode's existing forms with the kernel sources of several
checkouts, one after another on one card.

Each DIR is a checkout of this repository (its ``chip_smoke.py`` and
``src/``).  For each, in the order given, a fresh interpreter builds that
checkout's ``csrc/decode_attention.cu`` and times, through that checkout's
``chip_smoke.time_decode_attention``, the shapes ``chip_smoke.py`` times:
StarCoder2 heads at B=8 (lengths form over a serving cache and L=1024 and
4096, slot form over a serving cache and wrapped at W=1024),
RecurrentGemma-2B's wrapped 2048-slot window, and the log-sum-exp form at
long_500k's shard (B=1, Hq=3, Hkv=1, D=128, 32,768 wrapped slots: one rank
of Llama-4's global layer under a sequence-sharded cache).  Giving the
checkouts as
``parent change change parent`` brackets drift of the card.  Needs a CUDA
card and nvcc; prints the card's name and power limit, then one JSON line a
run ({"dir", "us": {form: kernel us}, "profiler_us": {form: us}})::

    python3 tools/decode_attention_ab.py DIR [DIR ...]
"""

from __future__ import annotations

import json
import subprocess
import sys

FORMS = [("serve", 1024, 64, False), ("L=1024", 1024, None, False),
         ("L=4096", 4096, None, False), ("slots serve", 1024, 64, True),
         ("slots wrapped W=1024", 1024, None, True)]

RUN = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as C
from repro_torch.kernels import _build
_build.build(["decode_attention"])
t = {{label: C.time_decode_attention(torch, label, s, top, slots)
     for label, s, top, slots in {forms!r}}}
dc = C.RECURRENTGEMMA_DECODE
t["recurrentgemma slots wrapped W=2048"] = C.time_decode_attention(
    torch, "recurrentgemma", dc["w"], None, True, dc["hq"], dc["hkv"], dc["d"], window=dc["w"])
t["long_500k shard lse"] = C.time_decode_attention(
    torch, "long_500k shard", 32768, None, True, hq=3, hkv=1, d=128, b=1, lse=True)
print(json.dumps({{"us": {{k: v["ms"] * 1e3 for k, v in t.items()}},
                  "profiler_us": {{k: v["profiler_ms"] * 1e3 for k, v in t.items()}}}}))
"""


def main(dirs) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    for root in dirs:
        out = subprocess.run([sys.executable, "-c", RUN.format(root=root, forms=FORMS)],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(json.dumps({"dir": root, **json.loads(out.stdout.strip().splitlines()[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
