"""Model stack of the port: training forward, loss and decode path of
decoders with full, sliding-window and chunked attention, dense and MoE
MLPs, and of Mamba-2 SSD stacks."""

from . import layers, moe, ssm, transformer
from .transformer import (Layer, Transformer, decode_step, embed_tokens,
                          forward, init_cache, init_params, lm_loss)

__all__ = ["Layer", "Transformer", "decode_step", "embed_tokens", "forward",
           "init_cache", "init_params", "layers", "lm_loss", "moe", "ssm", "transformer"]
