"""Batched serving engine: continuous-batching decode over the KV cache.

Counterpart of ``repro/serve/engine.py`` with the same semantics.
``ServeEngine`` keeps a fixed pool of ``max_batch`` sequence slots with a
shared KV cache on the device.  Requests join free slots (their prompt is
prefilled token by token through ``decode_step``), then all active slots
decode in lockstep, one token per engine step.  Each attention layer's
cache is a ring of ``max_len`` slots, so a sequence longer than that
attends to its last ``max_len`` positions, as in ``repro``.

Capacity hook: :meth:`ServeEngine.set_capacity` shrinks or restores the
usable slot count at run time.  Paused slots keep their request and cache
state frozen (their positions never advance, so the next decode rewrites
the same cache line) and resume decoding when capacity returns.

Positions and pending tokens stay host numpy arrays; the one host-device
sync of a step is reading its next tokens.

A VLM config is served as text only.  An encoder-decoder config decodes
against the encoder K/V in ``self.cache``: as in ``repro``, the engine
takes no frames, and the caller fills the cache with
:func:`~repro_torch.models.encode_to_cache` before submitting requests.

A config with recurrent layers (``"ssd"``, ``"rglru"``) keeps a state
that has no positions, so the engine masks its lanes: each prefill step
advances only the lane being filled, each engine step only the active
lanes (``decode_step``'s ``live``), so live and paused requests do not
leak into each other, and :meth:`ServeEngine.submit` first resets the
slot's lane to what :func:`~repro_torch.models.init_cache` gives, so a
reused slot starts from zeros.  ``repro``'s engine advances every lane at
every step (ROADMAP.md § 3), so the two give the same stream to a request
only while no other request is prefilled, paused or held in its slot: to
the first request into a fresh engine, served alone.  A config without
recurrent layers runs the unmasked step, as ``repro``'s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Transformer, decode_step, init_cache

@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: Transformer, max_batch: int = 4,
                 max_len: int = 256, *, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if model.device != device:
            raise ValueError(f"model lives on {model.device}, engine on {device}")
        self.cfg = cfg
        self.model = model
        self.device = device
        self.max_batch = max_batch
        self.max_len = max_len
        self.cache = init_cache(model, max_batch, max_len)
        self.positions = np.zeros((max_batch,), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pending_tok = np.zeros((max_batch,), np.int32)
        self.capacity = max_batch
        # lanes are masked only where a layer keeps a state without positions
        self.masked = any(layer.kind in ("ssd", "rglru") for layer in model.layers)

    def _step(self, live: Optional[np.ndarray] = None) -> torch.Tensor:
        """Decode the whole batch once; next tokens stay on the device.  In
        a masked engine only the ``live`` lanes ((B,) bool) advance their
        recurrent state."""
        nxt, self.cache = decode_step(self.model, self.cache, self.pending_tok[:, None],
                                      self.positions, live=live)
        obs.count("serve.decode_steps")
        return nxt

    def _reset_lane(self, i: int) -> None:
        """Lane ``i`` of every layer's cache as ``init_cache`` leaves it: the
        recurrent states and the conv and k/v caches zero, every slot's
        position -1 (empty)."""
        for c in self.cache:
            for name, t in c.items():
                if name not in ("xk", "xv"):
                    t[i].fill_(-1 if name == "pos" else 0)

    # ---------------------------------------------------------- capacity

    def set_capacity(self, active_slots: int) -> int:
        """Pause/restore slots: only indices ``< active_slots`` admit and
        decode.  Requests already sitting in a paused slot stay frozen (not
        dropped) until the capacity comes back.  Returns the clamped value."""
        self.capacity = max(0, min(int(active_slots), self.max_batch))
        obs.gauge("serve.capacity_slots", self.capacity)
        return self.capacity

    # ------------------------------------------------------------- admit

    def submit(self, req: Request) -> bool:
        """Prefill ``req`` into the first free slot below the capacity and
        take it; False when none is free.  A prompt longer than
        ``max_len`` wraps the ring-buffer cache, as in ``repro``.  An empty
        prompt raises ``ValueError``.  The slot is taken only once the
        prefill has run, so a submit that raises leaves every slot as it
        was."""
        if not req.prompt:
            raise ValueError(f"request {req.rid} has an empty prompt: nothing to prefill")
        for i, slot in enumerate(self.slots[:self.capacity]):
            if slot is None:
                only = None
                if self.masked:
                    self._reset_lane(i)
                    only = np.arange(self.max_batch) == i
                # prefill: feed prompt tokens through the decode path
                for j, tok in enumerate(req.prompt):
                    self.pending_tok[i] = tok
                    self.positions[i] = j
                    nxt = self._step(only)
                self.pending_tok[i] = int(nxt[i])
                self.positions[i] = len(req.prompt)
                req.out = [int(self.pending_tok[i])]
                self.slots[i] = req
                return True
        return False

    # -------------------------------------------------------------- step

    def step(self) -> int:
        """One lockstep decode for all active slots; returns #active.

        Slots at indices ``>= capacity`` are paused: they are excluded from
        the active count and their positions/pending token never advance
        (the decode still runs the full batch, but a paused lane rewrites
        the same cache line with the same token, a no-op, and in a masked
        engine keeps its recurrent state)."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i < self.capacity]
        if not active:
            return 0
        live = np.isin(np.arange(self.max_batch), active) if self.masked else None
        nxt = self._step(live).cpu().numpy()
        done = 0
        for i in active:
            req = self.slots[i]
            self.positions[i] += 1
            self.pending_tok[i] = nxt[i]
            req.out.append(int(nxt[i]))
            if len(req.out) >= req.max_new or \
                    self.positions[i] >= self.max_len - 1:
                req.done = True
                self.slots[i] = None
                done += 1
        if done:
            obs.count("serve.requests_completed", done)
        return len(active)

    def run_until_done(self, max_steps: int = 512) -> List[Request]:
        """Step until every *unpaused* slot drains, or ``max_steps``.

        Returns the requests still resident afterwards (hit the step
        budget, or parked in slots paused by :meth:`set_capacity`) instead
        of silently dropping them; the caller decides whether to resume,
        resubmit, or abandon them.  Leftovers are counted on the
        ``serve.unfinished_requests`` telemetry counter.
        """
        for _ in range(max_steps):
            if self.step() == 0:
                break
        leftover = [r for r in self.slots if r is not None]
        if leftover:
            obs.count("serve.unfinished_requests", len(leftover))
        return leftover
