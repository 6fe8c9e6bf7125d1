"""Model stack of the port: training forward, loss and decode path of
full-attention decoders."""

from . import layers, transformer
from .transformer import (Layer, Transformer, decode_step, embed_tokens,
                          forward, init_cache, init_params, lm_loss)

__all__ = ["Layer", "Transformer", "decode_step", "embed_tokens", "forward",
           "init_cache", "init_params", "layers", "lm_loss", "transformer"]
