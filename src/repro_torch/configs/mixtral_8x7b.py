"""Mixtral-8x7B [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, sliding-window attention.  [arXiv:2401.04088; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    layer_pattern=("swa",),
    window=4096,
    rope_theta=1e6,
    act="swiglu",
    n_experts=8,
    top_k=2,
    moe_every=1,
    tie_embeddings=False,
    max_seq=32768,
    subquadratic=True,           # SWA: KV cache bounded by the window
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1",
)
