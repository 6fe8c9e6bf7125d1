"""PaliGemma-3B [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216, SigLIP vision frontend STUBBED (input_specs provides patch
embeddings), gemma LM backbone with prefix-LM masking.
[arXiv:2407.07726; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,                # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    layer_pattern=("attn",),
    act="geglu",
    prefix_len=256,              # 224px / 14 -> 16x16 SigLIP patches
    frontend="vision_stub",
    tie_embeddings=True,
    max_seq=8192,
    subquadratic=False,          # full attention: long_500k skipped
    source="arXiv:2407.07726; hf:google/paligemma-3b-pt-224",
)
