"""Flash-decode: one query token per sequence against a KV cache."""

from .decode_attention import decode_attention, decode_attention_cache
from .ref import decode_attention_cache_ref, decode_attention_ref

__all__ = ["decode_attention", "decode_attention_cache", "decode_attention_cache_ref",
           "decode_attention_ref"]
