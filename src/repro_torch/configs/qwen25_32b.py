"""Qwen2.5-32B [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    layer_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
    act="swiglu",
    tie_embeddings=False,
    max_seq=32768,
    subquadratic=False,          # pure full attention: long_500k skipped
    source="hf:Qwen/Qwen2.5-32B",
)
