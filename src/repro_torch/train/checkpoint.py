"""Checkpoint and restart with the npz + JSON manifest scheme of
``repro/train/checkpoint.py``.

  * ``save(state, step, dir)``  -- synchronous atomic write (tmp + rename);
  * ``AsyncCheckpointer``       -- copy to host on the caller's thread, write
                                   on a background thread;
  * ``restore(dir, like)``      -- load the newest step into ``like``.

Leaves are keyed by their path: ``params/<parameter name>`` for the model
(``named_parameters``), ``opt/master/<name>``, ``opt/v/<name>/vr`` and
so on for the optimizer state, ``opt/step`` for the step counter.  npz
cannot store bfloat16, so a bf16 leaf is stored as its ``uint16`` view
under its key plus ``::bf16``, as the JAX package stores it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

BF16 = "::bf16"


def _items(x, prefix: str = ""):
    """(path, leaf) pairs of a state: modules, mappings, leaves."""
    if isinstance(x, nn.Module):
        for name, p in x.named_parameters():
            yield prefix + name, p
    elif isinstance(x, Mapping):
        for k, v in x.items():
            yield from _items(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), x


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (the caller may go on updating the original)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(state) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _items(state):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        flat[key + BF16 if bf16 else key] = _host(leaf)
    return flat


def _write(flat: Dict[str, np.ndarray], step: int, ckpt_dir) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp-step{step:08d}.npz"
    final = ckpt_dir / f"step{step:08d}.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, final)
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(flat.keys()), "file": final.name}
    mtmp = ckpt_dir / ".tmp-manifest.json"
    mtmp.write_text(json.dumps(manifest))
    os.replace(mtmp, ckpt_dir / "manifest.json")
    return final


def save(state, step: int, ckpt_dir) -> Path:
    return _write(_flatten(state), step, ckpt_dir)


class AsyncCheckpointer:
    """Snapshot on the caller thread (device -> host copy), write on a
    daemon thread; ``wait()`` joins the last write (call before exit)."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[Path] = None

    def save_async(self, state, step: int) -> None:
        self.wait()
        flat = _flatten(state)

        def _run():
            self.last_path = _write(flat, step, self.ckpt_dir)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir) -> Optional[int]:
    mf = Path(ckpt_dir) / "manifest.json"
    if not mf.exists():
        return None
    return json.loads(mf.read_text())["step"]


def _load(data, key: str, like) -> Any:
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            raw = torch.from_numpy(data[key + BF16].view(np.int16)).view(torch.bfloat16)
        else:
            raw = torch.from_numpy(data[key])
        if tuple(raw.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(raw.shape)}, "
                             f"state {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(raw)
        return like
    return type(like)(data[key].item())


def restore(ckpt_dir, like) -> Any:
    """Load the newest checkpoint into the structure of ``like``.  Tensors
    (the model's parameters included) are overwritten in place, on their
    own devices; scalars such as the step are replaced.  Returns ``like``."""
    ckpt_dir = Path(ckpt_dir)
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    with np.load(ckpt_dir / manifest["file"]) as data:
        def fill(x, prefix):
            if isinstance(x, nn.Module):
                for name, p in x.named_parameters():
                    _load(data, prefix + name, p)
                return x
            if isinstance(x, dict):
                for k in x:
                    x[k] = fill(x[k], f"{prefix}{k}/")
                return x
            return _load(data, prefix.rstrip("/"), x)
        return fill(like, "")
