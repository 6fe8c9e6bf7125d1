"""Decoder stack of the port: parameters, training forward and loss, KV
cache and one serving step.

Counterpart of ``repro/models/transformer.py``.  The layers are an
``nn.ModuleList`` walked by a Python loop (JAX stacks full pattern groups
and drives them with ``lax.scan``); each layer's weights keep the JAX
shapes, so ``x @ w`` reads the same in both.  Every attention layer runs a
hand-written kernel on the card: the flash-attention forward and backward
in :func:`forward` (:mod:`repro_torch.kernels.flash_attention`), flash-decode
in :func:`decode_step` (:mod:`repro_torch.kernels.decode_attention`).  Every
Mamba-2 (``"ssd"``) layer's forward and backward run the SSD-scan kernels
(:mod:`repro_torch.models.ssm`); its decode is the plain recurrence, as in
JAX.

This port covers the attention kinds (``"attn"``; ``"swa"``, a sliding
window of ``cfg.window`` positions; ``"chunked"``, attention within chunks
of ``cfg.window`` positions) and SSD layers, each with a dense MLP or, every
``moe_every``-th layer of a config with experts, an MoE MLP
(:mod:`repro_torch.models.moe`).  The other layer kinds, prefix (VLM) and
encoder-decoder inputs raise ``NotImplementedError`` naming the slice that
will port them; none of them runs a plain stand-in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention_cache
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

#: layer kinds (and features) that later slices of the port bring in
LATER_SLICE = {
    "rglru": "the RG-LRU slice",
    "enc": "the encoder-decoder slice",
    "xattn": "the encoder-decoder slice",
    "prefix inputs": "the VLM slice (PaliGemma prefix)",
}


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what!r} is not ported yet: it comes with "
        f"{LATER_SLICE.get(what, 'a later slice')}")


ATTN_KINDS = ("attn", "swa", "chunked")
#: the subtree that holds each layer kind's mixer
MIXERS = {**dict.fromkeys(ATTN_KINDS, "attn"), "ssd": "ssd"}


def _check_layer(cfg: ModelConfig, kind: str) -> None:
    if kind not in MIXERS:
        raise _unported(kind)
    if cfg.is_encdec:
        raise _unported("xattn")


def _pdict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


class Layer(nn.Module):
    """One decoder layer: norm1 -> mixer (``attn`` for the attention kinds,
    ``ssd``), then norm2 -> dense ``mlp`` or ``moe`` when the config has an
    MLP, both residual.  The subtrees and their names are those of
    ``repro``'s layer params."""

    def __init__(self, kind: str, norm1: Dict, *, attn: Optional[Dict] = None,
                 ssd: Optional[Dict] = None, norm2: Optional[Dict] = None,
                 mlp: Optional[Dict] = None, moe: Optional[Dict] = None):
        super().__init__()
        mixers = {"attn": attn, "ssd": ssd}
        held = sorted(k for k, v in mixers.items() if v is not None)
        if held != [MIXERS.get(kind)]:
            raise ValueError(f"a {kind!r} layer holds exactly its mixer; got {held}")
        if (norm2 is None) != (mlp is None and moe is None) or \
                (mlp is not None and moe is not None):
            raise ValueError("norm2 comes with one of mlp and moe")
        self.kind = kind
        self.norm1 = _pdict(norm1)
        for name, sub in (*mixers.items(), ("norm2", norm2), ("mlp", mlp)):
            setattr(self, name, _pdict(sub) if sub is not None else None)
        self.moe = MOE.MoE(**moe) if moe is not None else None


class Transformer(nn.Module):
    """The parameters of the whole model (``repro``'s params pytree)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 layers: List[Layer], final_norm: Dict,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _pdict(final_norm)
        self.lm_head = nn.Parameter(lm_head) if lm_head is not None else None

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ============================================================== init


def _init_attn(gen: torch.Generator, cfg: ModelConfig, device, dtype) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    hq, kv = cfg.padded_heads(1), cfg.padded_kv_heads(1)
    if hq % kv:
        raise ValueError(f"{hq} query heads do not group over {kv} KV heads")

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    s = 1.0 / math.sqrt(d)
    p = {"wq": normal((d, hq * hd), s), "wk": normal((d, kv * hd), s),
         "wv": normal((d, kv * hd), s),
         "wo": normal((hq * hd, d), 1.0 / math.sqrt(hq * hd))}
    if cfg.qkv_bias:
        for name, width in (("bq", hq), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((width * hd,), dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda", dtype=torch.bfloat16) -> Transformer:
    """Random weights with the JAX package's shapes and scales, drawn from
    ``generator`` (which must live on ``device``) and made on ``device``.
    Norm parameters stay float32, as in ``repro``."""
    device = torch.device(device)
    layers = []
    for i in range(cfg.num_layers):
        kind = cfg.pattern_at(i)
        _check_layer(cfg, kind)
        sub = {}
        if kind == "ssd":
            sub["ssd"] = SSM.init_ssd_block(generator, cfg, device, dtype)
        else:
            sub["attn"] = _init_attn(generator, cfg, device, dtype)
        if cfg.d_ff > 0:
            sub["norm2"] = L.init_norm(cfg.d_model, cfg.norm, device)
            if cfg.n_experts and i % cfg.moe_every == cfg.moe_every - 1:
                sub["moe"] = MOE.init_moe(generator, cfg, device, dtype)
            else:
                sub["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                                        device, dtype)
        layers.append(Layer(kind, L.init_norm(cfg.d_model, cfg.norm, device), **sub))
    vp = cfg.padded_vocab()
    emb = (torch.randn((vp, cfg.d_model), generator=generator, device=device)
           * 0.02).to(dtype)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = (torch.randn((cfg.d_model, vp), generator=generator,
                               device=device) * 0.02).to(dtype)
    return Transformer(cfg, emb, layers,
                       L.init_norm(cfg.d_model, cfg.norm, device), lm_head)


# ============================================================== training


def embed_tokens(model: Transformer, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup (the JAX package's off-mesh path)."""
    return model.embed[ids]


def lm_loss(model: Transformer, x: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the next-token labels (the JAX
    package's off-mesh path): float32 logits over the padded vocabulary,
    cut to ``vocab_size``, logsumexp minus the label's logit."""
    w = model.lm_head if model.lm_head is not None else model.embed.T
    logits = (x @ w).float()[..., :model.cfg.vocab_size]
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - lab)


def _attn_apply(p: nn.ParameterDict, cfg: ModelConfig, x: torch.Tensor,
                kind: str, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (train/prefill), within ``cfg.window``
    positions for ``"swa"`` and within chunks of ``cfg.window`` positions
    for ``"chunked"``.  x: (B, S, d)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    hq = p["wq"].shape[-1] // hd
    kvh = p["wk"].shape[-1] // hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q.reshape(b, s, hq, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, kvh, hd)
    out = L.flash_attention(q, k, v, causal=True, **_mask(cfg, kind))
    return out.reshape(b, s, hq * hd) @ p["wo"]


def _mask(cfg: ModelConfig, kind: str) -> Dict[str, int]:
    return {"window": cfg.window if kind == "swa" else 0,
            "chunk": cfg.window if kind == "chunked" else 0}


def _mlp_apply(layer: Layer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The residual MLP half of a layer: dense, or MoE on one device (what
    ``repro``'s ``_moe_dispatch`` runs without a mesh)."""
    if layer.norm2 is None:
        return x
    h2 = L.norm(x, layer.norm2, cfg.norm)
    if layer.moe is not None:
        return x + MOE.moe_apply_local(layer.moe, cfg, h2, tp=1)
    return x + L.mlp_apply(layer.mlp, h2, cfg.act)


def _layer_apply(layer: Layer, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = L.norm(x, layer.norm1, cfg.norm)
    if layer.kind == "ssd":
        x = x + SSM.ssd_block_apply(layer.ssd, cfg, h)[0]
    else:
        x = x + _attn_apply(layer.attn, cfg, h, layer.kind, positions)
    return _mlp_apply(layer, cfg, x)


def forward(model: Transformer, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, d).

    With ``remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as JAX wraps each group in ``jax.checkpoint`` with
    nothing saveable: only the layer inputs stay alive, and each layer's
    forward, its flash-attention or SSD-scan kernel included, runs again
    during the backward pass."""
    cfg = model.cfg
    for key in ("patches", "frames"):
        if key in batch:
            raise _unported("xattn" if key == "frames" else "prefix inputs")
    tokens = batch["tokens"]
    x = embed_tokens(model, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for layer in model.layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer_apply, layer, cfg, x, positions,
                           use_reentrant=False)
        else:
            x = _layer_apply(layer, cfg, x, positions)
    return L.norm(x, model.final_norm, cfg.norm)


# ============================================================== serving


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind in ("swa", "chunked") and cfg.window:
        return min(cfg.window, max_len)
    return max_len


def init_cache(model: Transformer, batch: int, max_len: int,
               dtype=torch.bfloat16) -> List[Dict[str, torch.Tensor]]:
    """Zeroed caches, one dict per layer, on the model's device: for an
    attention layer ``k`` and ``v`` (B, W, Hkv, D) in ``dtype`` and ``pos``
    (B, W) int32, -1 = empty; for an SSD layer its state and conv caches
    (:func:`repro_torch.models.ssm.init_ssd_cache`)."""
    cfg = model.cfg
    hd = cfg.head_dim
    cache = []
    for layer in model.layers:
        if layer.kind == "ssd":
            cache.append(SSM.init_ssd_cache(cfg, batch, dtype, model.device))
            continue
        kvh = layer.attn["wk"].shape[-1] // hd
        wc = _cache_len(cfg, layer.kind, max_len)
        cache.append({
            "k": torch.zeros((batch, wc, kvh, hd), dtype=dtype, device=model.device),
            "v": torch.zeros((batch, wc, kvh, hd), dtype=dtype, device=model.device),
            "pos": torch.full((batch, wc), -1, dtype=torch.int32, device=model.device),
        })
    return cache


def _attn_decode(p: nn.ParameterDict, cfg: ModelConfig, x: torch.Tensor,
                 kind: str, position: torch.Tensor,
                 cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One-token attention against the layer's ring-buffer cache.

    x: (B, 1, d); position: (B,) int32 absolute positions on the device.
    Position ``t`` goes to slot ``t % W``, as in ``repro``, so a sequence
    longer than the cache attends to its last W positions.  The cache is
    updated in place (``index_put_``), where JAX builds a new one with
    ``.at[].set``.  ``"swa"`` and ``"chunked"`` layers mask by ``cfg.window``
    as in :func:`_attn_apply`.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    hq = p["wq"].shape[-1] // hd
    kvh = p["wk"].shape[-1] // hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos_b = position[:, None]
    q = L.apply_rope(q.reshape(b, 1, hq, hd), pos_b, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, 1, kvh, hd), pos_b, cfg.rope_theta)
    v = v.reshape(b, 1, kvh, hd)

    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    slot = (position % kc.shape[1]).long()
    bi = torch.arange(b, device=x.device)
    kc.index_put_((bi, slot), k[:, 0].to(kc.dtype))
    vc.index_put_((bi, slot), v[:, 0].to(vc.dtype))
    pc.index_put_((bi, slot), position)

    out = decode_attention_cache(q, kc, vc, pc, position,
                                 **_mask(cfg, kind))          # (B, 1, Hq, D)
    return out.reshape(b, 1, hq * hd) @ p["wo"]


def _layer_decode(layer: Layer, cfg: ModelConfig, x: torch.Tensor,
                  position: torch.Tensor,
                  cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = L.norm(x, layer.norm1, cfg.norm)
    if layer.kind == "ssd":
        # every lane advances its state by one token: lanes run in lockstep
        y, new = SSM.ssd_block_apply(layer.ssd, cfg, h, cache, decode=True)
        cache.update(new)
        x = x + y
    else:
        x = x + _attn_decode(layer.attn, cfg, h, layer.kind, position, cache)
    # every lane, idle and paused ones too, goes through an MoE router and
    # competes for expert capacity, as in repro
    return _mlp_apply(layer, cfg, x)


@torch.no_grad()
def decode_step(model: Transformer, cache: List[Dict[str, torch.Tensor]],
                tokens, position) -> Tuple[torch.Tensor, List[Dict]]:
    """One serving step: (B, 1) tokens at (B,) positions -> (B,) int32 next
    tokens on the model's device, plus the cache (updated in place).

    ``tokens`` and ``position`` are host integer arrays (numpy or CPU
    tensors), as the serving engine keeps them; they go to the device in one
    copy that does not wait for it, so the step itself needs no host-device
    sync, and nothing in it depends on the positions' values on the host.
    An SSD layer's state has no positions: each call advances every lane by
    one token, so its lanes must move in lockstep.
    """
    cfg = model.cfg
    dev = model.device
    host = np.concatenate([np.asarray(tokens, np.int64).reshape(-1),
                           np.asarray(position, np.int64).reshape(-1)])
    both = torch.from_numpy(host)
    if dev.type == "cuda":      # a pinned source lets the copy skip the wait
        both = both.pin_memory()
    both = both.to(dev, non_blocking=True)
    tok, pos = both.view(2, -1)
    pos = pos.to(torch.int32)
    x = embed_tokens(model, tok[:, None])                    # (B, 1, d)
    for layer, c in zip(model.layers, cache):
        x = _layer_decode(layer, cfg, x, pos, c)
    x = L.norm(x, model.final_norm, cfg.norm)
    w = model.lm_head if model.lm_head is not None else model.embed.T
    logits = (x[:, 0] @ w).float()
    vmask = torch.arange(logits.shape[-1], device=dev) < cfg.vocab_size
    logits = logits.masked_fill(~vmask[None], -float("inf"))
    return torch.argmax(logits, dim=-1).to(torch.int32), cache
