"""DeepSeek-67B [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama architecture.  [arXiv:2401.02954; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    layer_pattern=("attn",),
    act="swiglu",
    tie_embeddings=False,
    max_seq=4096,
    subquadratic=False,          # pure full attention: long_500k skipped
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
)
