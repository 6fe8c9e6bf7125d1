"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --full --batch 1 --seq 8192
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2 --full --batch 4 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma --full --batch 1 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper --full --batch 16 --seq 448
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma --full --batch 1 --seq 4096

Runs on the card unless ``--device cpu`` is given.  Without ``--full`` the
model is the arch's ``reduced()`` config, as in ``repro.launch.train``.
``--arch`` takes the architectures the port registers (``h2o-danube``,
``mixtral``, ``llama4``, ``qwen``, ``deepseek``, ``gpt-moe``, ``starcoder2``,
``mamba2``, ``recurrentgemma``, ``paligemma``, ``whisper`` or their full
names) and defaults to ``repro``'s ``h2o-danube``.  ``--seq`` counts
PaliGemma's 256 patches;
Whisper's batches also carry 1500 float32 frames a sequence.
The last line is the JSON summary of ``repro.launch.train``.
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the published config instead of reduced()")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.data import data_iter
    from repro_torch.train.loop import TrainConfig, train_loop

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    tcfg = TrainConfig(microbatches=args.microbatches)
    data = data_iter(cfg, args.batch, args.seq, device=device)

    cb, saver = None, None
    if args.ckpt:
        saver = ckpt_mod.AsyncCheckpointer(args.ckpt)
        cb = lambda state, step: saver.save_async(state, step)  # noqa: E731

    state, hist = train_loop(cfg, tcfg, data, args.steps, device=device,
                             checkpoint_cb=cb, checkpoint_every=20)
    if saver is not None:
        saver.wait()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(json.dumps({"arch": cfg.name, "steps": args.steps,
                      "first_loss": first, "last_loss": last}))


if __name__ == "__main__":
    main()
