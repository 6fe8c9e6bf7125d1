"""Mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # no MLP: SSD blocks only (Mamba-2 style)
    vocab_size=50280,
    layer_pattern=("ssd",),
    act="silu",
    norm="rmsnorm",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    conv_width=4,
    tie_embeddings=True,
    max_seq=1048576,
    subquadratic=True,           # O(1)-state decode
    source="arXiv:2405.21060; unverified",
)
