"""Model stack of the port: training forward, loss and decode path of
decoders with full, sliding-window, chunked and prefix-LM attention, dense
and MoE MLPs, of Mamba-2 SSD stacks, of RG-LRU hybrids and of
encoder-decoder models."""

from . import layers, moe, rglru, ssm, transformer
from .transformer import (Encoder, Layer, Transformer, decode_step, embed_tokens,
                          encode, encode_to_cache, forward, init_cache, init_params,
                          lm_loss)

__all__ = ["Encoder", "Layer", "Transformer", "decode_step", "embed_tokens", "encode",
           "encode_to_cache", "forward", "init_cache", "init_params", "layers", "lm_loss",
           "moe", "rglru", "ssm", "transformer"]
