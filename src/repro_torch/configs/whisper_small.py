"""Whisper-small [audio] — enc-dec, 12L d_model=768 12H (MHA kv=12)
d_ff=3072 vocab=51865, conv frontend STUBBED (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,               # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern=("attn",),
    act="gelu",
    norm="layernorm",
    enc_layers=12,
    enc_seq=1500,                # 30s of audio at 50Hz after the conv stub
    frontend="audio_stub",
    tie_embeddings=True,
    max_seq=32768,               # mechanically supported decode context
    subquadratic=False,          # full attention: long_500k skipped
    source="arXiv:2212.04356; unverified",
)
