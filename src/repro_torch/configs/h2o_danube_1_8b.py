"""H2O-Danube-1.8B [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,                 # 2560 / 32
    d_ff=6912,
    vocab_size=32000,
    layer_pattern=("swa",),
    window=4096,
    act="swiglu",
    tie_embeddings=False,
    max_seq=16384,
    subquadratic=True,           # SWA: KV cache bounded by the window
    source="arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base",
)
