"""Serving launcher: batched requests through the port's ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2 --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2 --device cpu

Runs on the card unless ``--device cpu`` is given.  Without ``--full`` the
model is the arch's ``reduced()`` config, as in ``repro.launch.serve``.
``--arch`` takes the names of ``repro_torch.configs``.  At full depth the
bf16 weights of Mixtral-8x7B, DeepSeek-67B, Llama-4 Maverick and GPT-MoE
exceed one 80 GB card.  PaliGemma is served as text only, as in ``repro``.
An encoder-decoder config (Whisper) first fills the engine's cache with
``encode_to_cache`` over float32 stub frames drawn from seed 0, one
utterance a slot.  Configs with recurrent layers (Mamba-2, RecurrentGemma;
reduced, or Mamba2-780m and RecurrentGemma-2B with ``--full``) are served
with the engine's lane mask: each request's state advances only on its
own steps (see the engine's docstring).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="use the published config instead of reduced()")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.models import encode_to_cache, init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_params(cfg, gen, device=device)
    eng = ServeEngine(cfg, model, max_batch=args.max_batch, max_len=128,
                      device=device)
    rng = np.random.default_rng(0)
    if cfg.is_encdec:
        frames = rng.standard_normal((args.max_batch, cfg.enc_seq, cfg.d_model)) * 0.02
        eng.cache = encode_to_cache(model, eng.cache,
                                    torch.from_numpy(frames.astype(np.float32)))

    pending = [Request(i, rng.integers(0, cfg.vocab_size, 6).tolist(),
                       max_new=args.max_new) for i in range(args.requests)]
    done = []
    t0 = time.perf_counter()
    steps = 0
    while pending or any(s is not None for s in eng.slots):
        while pending and eng.submit(pending[0]):
            done.append(pending.pop(0))
        eng.step()
        steps += 1
        if steps > 2000:
            break
    dt = time.perf_counter() - t0
    toks = sum(len(r.out or []) for r in done)
    print(json.dumps({"arch": cfg.name, "requests": len(done),
                      "tokens": toks, "engine_steps": steps,
                      "tok_per_s": round(toks / dt, 1), "device": str(device)}))


if __name__ == "__main__":
    main()
