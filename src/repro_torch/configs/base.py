"""Model architecture config, the port's counterpart of ``repro.configs.base``.

``ModelConfig`` carries the exact public hyper-parameters of an
architecture, the padding rules the model reads, a ``reduced()`` variant
for CPU tests, and the analytic ``param_count`` and
``active_param_count`` that MFU reads (an MoE step counts only the top-k
experts).  ``ShapeConfig`` and ``SHAPES`` are the four input-shape cells of
the dry run (:mod:`repro_torch.launch.dryrun`), and :func:`input_specs`
gives a cell's inputs as empty tensors, on the ``meta`` device by default.
Pure Python at import: :func:`input_specs` imports torch when it is called.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

# ---------------------------------------------------------------- shapes


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------- model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention pattern: cycle of per-layer kinds over the stack
    layer_pattern: Tuple[str, ...] = ("attn",)
    # attn: global causal; swa: sliding window; chunked: llama4 iRoPE local
    # rglru: RG-LRU recurrent block; ssd: mamba2 SSD block; enc: bidirectional
    window: int = 0                  # SWA / local-attn window
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    act: str = "swiglu"              # swiglu | gelu | geglu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # MoE MLP every k-th layer
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    # RG-LRU
    rnn_width: int = 0               # lru hidden width (defaults d_model)
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0                 # encoder frames (whisper: 1500)
    # vlm
    prefix_len: int = 0              # vision token prefix (paligemma: 256)
    frontend: str = "none"           # none | audio_stub | vision_stub
    tie_embeddings: bool = True
    max_seq: int = 8192
    subquadratic: bool = False       # can run long_500k
    source: str = ""

    # ----------------------------------------------------------- derived

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def padded_heads(self, tp: int) -> int:
        """Query heads padded up to a multiple of TP (Megatron rule)."""
        return math.ceil(self.n_heads / tp) * tp

    def padded_kv_heads(self, tp: int) -> int:
        """KV heads replicated (Megatron GQA rule) to the smallest multiple
        of the originals that (a) shards evenly over TP and (b) divides the
        padded query heads, so every shard holds whole KV heads and an
        integer query-per-KV replication factor."""
        ph = self.padded_heads(tp)
        kv = max(self.n_kv_heads, 1)
        for r in range(1, ph // kv + 1):
            kvp = kv * r
            if kvp % tp == 0 and ph % kvp == 0:
                return kvp
        return ph

    def padded_vocab(self, multiple: int = 128) -> int:
        return math.ceil(self.vocab_size / multiple) * multiple

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def pattern_at(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def param_count(self) -> float:
        """Approximate parameter count (used for MODEL_FLOPS = 6 N D)."""
        d, f = self.d_model, self.d_ff
        total = 0.0
        for i in range(self.num_layers):
            kind = self.pattern_at(i)
            if kind in ("attn", "swa", "chunked", "enc"):
                total += d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                total += self.n_heads * self.head_dim * d
            elif kind == "rglru":
                w = self.rnn_width or d
                total += 2 * d * w + 3 * w * w // max(w, 1) + w * d  # proj + gates
                total += 2 * w  # lambda, conv-ish
            elif kind == "ssd":
                di = self.d_inner
                total += d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                total += di * d
            if f > 0:
                mats = 3 if self.act in ("swiglu", "geglu") else 2
                if self.n_experts and (i % self.moe_every == self.moe_every - 1):
                    total += self.n_experts * mats * d * f
                    total += d * self.n_experts  # router
                    total += self.n_shared_experts * mats * d * f
                else:
                    total += mats * d * f
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            for _ in range(self.enc_layers):
                total += 4 * d * d + (3 if self.act in ("swiglu", "geglu") else 2) * d * f
                # decoder cross-attention
            total += self.num_layers * 4 * d * d
        return total

    def active_param_count(self) -> float:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mats = 3 if self.act in ("swiglu", "geglu") else 2
        n_moe = self.num_layers // self.moe_every
        inactive = (self.n_experts - self.top_k) * mats * d * f * n_moe
        return self.param_count() - inactive

    # ----------------------------------------------------------- reduced

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        pat = len(self.layer_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=max(pat, 2 if pat == 1 else pat),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 32) if self.window else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 128,
            rnn_width=64 if self.rnn_width else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=16 if self.enc_seq else 0,
            prefix_len=4 if self.prefix_len else 0,
            max_seq=128,
        )


# ------------------------------------------------------------- input specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=None, device="meta",
                batch: int = 0) -> Dict:
    """Empty input tensors of ``shape`` (``repro``'s ``input_specs``), on
    ``device`` (``meta``: shapes and dtypes only, nothing allocated).

    Training: token and label ids.  Prefill: token ids.  Decode: one new
    token a sequence and its position; the cache is the model's.  Ids and
    positions are int32.  Modality frontends are stubs: Whisper sees frame
    embeddings and PaliGemma patch embeddings in ``dtype`` (default
    bfloat16).  ``batch`` > 0 replaces the global batch (one rank's
    share)."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    b, s = batch or shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=device)
    emb = dict(dtype=dtype, device=device)
    specs: Dict[str, "torch.Tensor"] = {}
    if shape.kind in ("train", "prefill"):
        text = s - cfg.prefix_len
        specs["tokens"] = torch.empty((b, text), **i32)
        if shape.kind == "train":
            specs["labels"] = torch.empty((b, text), **i32)
        if cfg.is_encdec:
            specs["frames"] = torch.empty((b, cfg.enc_seq, cfg.d_model), **emb)
        if cfg.prefix_len:
            specs["patches"] = torch.empty((b, cfg.prefix_len, cfg.d_model), **emb)
    else:  # decode: one token, cache of length s
        specs["tokens"] = torch.empty((b, 1), **i32)
        specs["position"] = torch.empty((b,), **i32)
    return specs
