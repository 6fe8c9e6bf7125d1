"""GPT-MoE 1.1T — the paper's own Appendix-B model, included so the paper's
Tables 4/5 experiments run through the same stack as the assigned archs."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gpt-moe-1.1t",
    family="moe",
    num_layers=192,
    d_model=12288,
    n_heads=128,
    n_kv_heads=128,
    head_dim=96,
    d_ff=49152,
    vocab_size=64000,
    layer_pattern=("attn",),
    act="gelu",
    n_experts=8,
    top_k=2,
    moe_every=2,                 # MoE layer ratio 0.5
    tie_embeddings=False,
    max_seq=2048,
    subquadratic=False,
    source="paper Appendix B",
)
