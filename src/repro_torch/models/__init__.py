"""Model stack of the port: the decode path of full-attention decoders."""

from . import layers, transformer
from .transformer import (Layer, Transformer, decode_step, embed_tokens,
                          init_cache, init_params)

__all__ = ["Layer", "Transformer", "decode_step", "embed_tokens",
           "init_cache", "init_params", "layers", "transformer"]
