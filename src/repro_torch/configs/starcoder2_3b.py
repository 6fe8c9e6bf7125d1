"""StarCoder2-3B [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, GQA + RoPE.  [arXiv:2402.19173; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    layer_pattern=("attn",),
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=1e5,
    tie_embeddings=True,
    max_seq=16384,
    subquadratic=False,          # treated as full attention: long_500k skipped
    source="arXiv:2402.19173; hf:bigcode/starcoder2-3b",
)
