"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package holds the wrapper that launches its kernel on CUDA tensors
(with a launch count) and, beside it, the plain PyTorch version that CPU
tensors take and that the kernel is held against on the card.  The CUDA
sources live in ``repro_torch/csrc`` and are built at first use by
:mod:`repro_torch.kernels._build`.

  * decode_attention -- flash-decode against a KV cache (replaces
    ``repro.kernels.decode_attention.decode_attention_pallas``)
  * flash_attention -- blockwise attention forward and its gradient
    (replaces ``repro.kernels.flash_attention.flash_attention_pallas`` and
    the custom VJP of ``repro.models.layers.flash_attention_xla``)
  * ssd_scan -- Mamba-2 chunked SSD scan forward and its gradient
    (replaces ``repro.kernels.ssd_scan.ssd_scan_pallas``; JAX takes the
    gradient of ``repro.models.ssm.ssd_chunked`` with XLA)
"""
