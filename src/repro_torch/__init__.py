"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Each subpackage mirrors its counterpart in ``repro`` and imports neither
JAX nor ``repro``.  Every TPU kernel on a ported path is a kernel written
by hand for Hopper (``repro_torch/csrc``), with its plain PyTorch version
beside it.  Entry points run on ``cuda`` unless given ``device="cpu"``.
"""
