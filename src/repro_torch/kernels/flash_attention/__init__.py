"""Flash attention for training and prefill: forward and backward."""

from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_fwd)
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_fwd",
           "flash_attention_bwd_ref", "flash_attention_fwd_ref"]
