"""Deterministic synthetic data, the port's copy of ``repro/train/data.py``.

Batch ``i`` is a pure function of (seed, step), so a restarted job
regenerates exactly the batches it would have seen.  ``synthetic_batch``
is numpy code identical to the JAX package's and gives the same arrays bit
for bit; ``data_iter`` keeps a background prefetch thread and yields
tensors on the requested device.

The token stream is a mixture of Zipf-distributed unigrams and short
repeated motifs, so models can actually reduce loss on it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def synthetic_batch(cfg: ModelConfig, step: int, batch: int, seq: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed * 1_000_003 + step)
    v = cfg.vocab_size
    text = seq - cfg.prefix_len
    # zipf unigrams + motif repeats => learnable structure
    base = (rng.zipf(1.3, size=(batch, text + 1)) - 1) % v
    motif = rng.integers(0, v, size=(batch, 8))
    pos = rng.integers(0, max(text - 16, 1), size=(batch,))
    for b in range(batch):
        base[b, pos[b]:pos[b] + 8] = motif[b]
        base[b, pos[b] + 8:pos[b] + 16] = motif[b]
    toks = base[:, :-1].astype(np.int32)
    labels = base[:, 1:].astype(np.int32)
    out = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.prefix_len:
        out["patches"] = rng.standard_normal(
            (batch, cfg.prefix_len, cfg.d_model)).astype(np.float32) * 0.02
    return out


def data_iter(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
              start_step: int = 0, prefetch: int = 2,
              device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetching iterator of batches on ``device``; ``start_step``
    resumes mid-stream after a restart.  An error in the producer thread is
    raised here, where ``repro``'s iterator would wait forever."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    device = torch.device(device)

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                item = synthetic_batch(cfg, step, batch, seq, seed)
            except Exception as e:           # handed to the consumer
                item = e
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            host = q.get()
            if isinstance(host, Exception):
                raise host
            yield {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    finally:
        stop.set()
