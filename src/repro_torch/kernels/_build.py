"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into ``_build/<name>-<hash>.so`` inside the package, with a plain
C interface that :func:`load` opens through ``ctypes``.  A source listed in
:data:`PARTS` is compiled as that many translation units at once (part k
with ``-D<macro>=k``, each its share of the kernel instances), which are
then linked into one library.  The hash covers the
sources and the flags, so an edited source is rebuilt and an unchanged one is
reused.  Only the sources in the package are compiled; a failed build raises
with nvcc's output.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# sources compiled in parts: {name: (the macro that picks a part, parts)}
PARTS = {"decode_attention": ("DECODE_ATTENTION_PART", 4)}


class BuildError(RuntimeError):
    """nvcc failed or is missing."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                     "built on the machine that has the card")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(PARTS.get(name)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, all at once
    (one nvcc each, or one a part, started together).  Returns ``{name: ptxas report}``
    for the sources compiled by this call; raises :class:`BuildError`
    on the first failure, with nvcc's output."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    jobs = {}          # name: (library's temporary path, its path, [(object or None, nvcc)])
    for name, out in todo.items():
        tmp = tempfile.NamedTemporaryFile(dir=BUILD, suffix=".so.tmp", delete=False)
        tmp.close()
        src = str(CSRC / f"{name}.cu")
        if name not in PARTS:
            cmd = [exe, *NVCC_FLAGS, "-o", tmp.name, src]
            jobs[name] = (tmp.name, out, [(None, _start(cmd))])
            continue
        macro, n = PARTS[name]
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [f"{tmp.name}.{k}.o" for k in range(n)]
        jobs[name] = (tmp.name, out, [
            (obj, _start([exe, *flags, f"-D{macro}={k}", "-c", "-o", obj, src]))
            for k, obj in enumerate(objs)])
    reports, failed = {}, []
    for name, (tmp, out, procs) in jobs.items():
        logs, ok = [], True
        for _, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            ok = ok and proc.returncode == 0
        objs = [obj for obj, _ in procs if obj]
        if ok and objs:
            link = subprocess.run([exe, "-shared", "-o", tmp, *objs], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            ok = link.returncode == 0
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
        log = "".join(logs)
        if not ok:
            failed.append(f"nvcc {name}.cu failed:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
            reports[name] = log
    if failed:
        raise BuildError("\n".join(failed))
    return reports


def _start(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and open its library."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
