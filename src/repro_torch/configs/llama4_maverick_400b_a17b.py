"""Llama-4 Maverick 400B-A17B [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion, iRoPE chunked attention.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    # iRoPE: 3 chunked-local layers then 1 global-attention layer
    layer_pattern=("chunked", "chunked", "chunked", "attn"),
    window=8192,                  # local attention chunk size
    act="swiglu",
    n_experts=128,
    top_k=1,
    moe_every=2,                  # experts interleaved every other layer
    n_shared_experts=1,
    tie_embeddings=False,
    max_seq=1048576,
    subquadratic=True,            # 3/4 of layers are chunked; global layers
                                  # decode O(S) per token with seq-sharded KV
    source="hf:meta-llama/Llama-4-Scout-17B-16E (scaled); unverified",
)
