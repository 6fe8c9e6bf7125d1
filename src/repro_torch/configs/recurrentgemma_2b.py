"""RecurrentGemma-2B [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention in a 2:1 pattern.
[arXiv:2402.19427; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "swa"),
    window=2048,                 # local attention window
    act="geglu",
    rnn_width=2560,
    conv_width=4,
    tie_embeddings=True,
    max_seq=1048576,
    subquadratic=True,           # recurrent state + bounded local-attn cache
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)
