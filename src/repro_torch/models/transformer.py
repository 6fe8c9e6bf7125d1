"""Model stack of the port: parameters, training forward and loss, KV
cache and one serving step, plus the encoder of encoder-decoder configs.

Counterpart of ``repro/models/transformer.py``.  The layers are an
``nn.ModuleList`` walked by a Python loop (JAX stacks full pattern groups
and drives them with ``lax.scan``); each layer's weights keep the JAX
shapes, so ``x @ w`` reads the same in both.  Every attention layer runs a
hand-written kernel on the card: the flash-attention forward and backward
in :func:`forward` (:mod:`repro_torch.kernels.flash_attention`), flash-decode
in :func:`decode_step` (:mod:`repro_torch.kernels.decode_attention`).  Every
Mamba-2 (``"ssd"``) layer's forward and backward run the SSD-scan kernels
(:mod:`repro_torch.models.ssm`); its decode is the plain recurrence, as in
JAX.  An RG-LRU (``"rglru"``) layer runs :mod:`repro_torch.models.rglru`,
whose scan is torch code, as ``repro``'s is XLA's.

This port covers the attention kinds (``"attn"``; ``"swa"``, a sliding
window of ``cfg.window`` positions; ``"chunked"``, attention within chunks
of ``cfg.window`` positions; ``"enc"``, the bidirectional encoder layers
without RoPE), SSD and RG-LRU layers, each with a dense MLP or, every
``moe_every``-th layer of a config with experts, an MoE MLP
(:mod:`repro_torch.models.moe`).  A VLM config (``cfg.prefix_len``) puts
``batch["patches"]`` before the tokens and attends bidirectionally within
that prefix.  An encoder-decoder config (``cfg.enc_layers``) runs
:func:`encode` over ``batch["frames"]`` and gives every decoder layer a
non-causal cross-attention to its output; in serving, :func:`encode_to_cache`
writes each layer's cross K/V into the cache, and :func:`decode_step` reads
all of them through flash-decode's lengths form.  A layer kind that
``repro`` does not have raises ``NotImplementedError``; nothing runs a plain
stand-in.

Under a mesh (``repro_torch.parallel.parallel_rules(rules, mesh)``) every
rank runs these functions on its own shards: the batch split over
``data`` (and ``pod``), attention heads, the MLP's ``ff`` and the
vocabulary split over ``model`` (``shard_params`` in
:mod:`repro_torch.convert` cuts them).  Where ``repro`` leaves the
collectives to GSPMD, the port runs them:

* Sequence parallelism (rules that map ``seq_sp``, as ``DEFAULT_RULES``
  do): the residual stream between the layers, and so each layer input
  that remat saves, is this rank's slice of the sequence over the
  ``seq_sp`` axis, and :func:`forward` returns that slice.  A sequence the
  axis does not divide gets zero rows in front (on the axis's first rank)
  up to a multiple of its size, as GSPMD pads uneven shards; they are cut
  after each gather.  A tensor-parallel region (attention, the dense MLP,
  the loss) is entered by a ring all-gather of the normed slice (its
  backward a reduce-scatter of the partial gradients) and left by a ring
  reduce-scatter (its backward an all-gather); the embedding's partial
  lookups leave by a reduce-scatter too.  The MoE layer sees the whole
  sequence, as ``repro`` feeds it, so that capacity and routing see every
  token: its input is gathered (backward: this rank's slice) and its
  replicated output split.  RoPE positions and the flash masks are those
  of the whole sequence.
* With ``seq_sp`` unmapped the residual stream is replicated over
  ``model``: a column-parallel region is entered through Megatron's *f*
  (identity forward, all-reduce of the gradient backward) and a
  row-parallel partial sum leaves through *g* (``psum``: all-reduce
  forward, identity backward); the embedding is a masked local lookup and
  a ``psum``.
* FSDP (rules that map ``fsdp``, e.g. ``mesh_axes({"fsdp": "data"})``):
  each weight with an ``fsdp`` dimension is held split over that axis too,
  and each layer ring all-gathers its weights when it starts (their
  backward a reduce-scatter, which sums the data shards' gradients); under
  remat the recompute gathers again, so no gathered weight outlives its
  layer.

The loss is the fused vocab-parallel softmax cross-entropy, and the MoE
layers run :func:`~repro_torch.models.moe.moe_apply_local` on the model
axis.  SSD and RG-LRU layers are tensor-parallel over ``ff`` like the dense
MLP, entered and left the same way: their recurrences run over the whole
sequence on this rank's channels (:mod:`repro_torch.models.ssm`,
:mod:`repro_torch.models.rglru`).

:func:`decode_step` runs under a mesh too, with the same tensor-parallel
layout and one token a lane (no sequence parallelism); a cache whose slots
are split over a mesh axis (``seq_shard``: ``long_500k``'s sequence over
``data``, the ``kvdedup`` cells' over ``model``) runs the flash-decode
kernel's log-sum-exp form on each rank's slots and merges the partial
attentions across the axis (:func:`_attn_decode`).

Dtypes follow ``repro``'s promotions: ``x @ w`` of float32 activations and
bf16 weights computes in float32 (:func:`~repro_torch.models.layers.matmul`),
so float32 frames keep the whole encoder, and the cross K/V projected from
it, in float32 beside bf16 decoder activations.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_cache
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.parallel.collectives import (copy_to, gather_from, pmax, psum,
                                              ring_all_gather, ring_reduce_scatter, split_to)
from repro_torch.parallel.mesh import Axis, mesh_axis
from repro_torch.parallel.sharding import get_mesh, get_rules, resolve, seq_sp_axis
from repro_torch.parallel.specs import fsdp_dim

#: layer kinds that later slices of the port bring in (none is left)
LATER_SLICE: Dict[str, str] = {}


def _unported(what: str) -> NotImplementedError:
    if what in LATER_SLICE:
        return NotImplementedError(f"{what!r} is not ported yet: it comes with "
                                   f"{LATER_SLICE[what]}")
    return NotImplementedError(f"unknown layer kind {what!r}; the port runs "
                               f"{sorted(MIXERS)}")


ATTN_KINDS = ("attn", "swa", "chunked", "enc")
#: the subtree that holds each layer kind's mixer
MIXERS = {**dict.fromkeys(ATTN_KINDS, "attn"), "ssd": "ssd", "rglru": "rglru"}


def _check_layer(kind: str) -> None:
    if kind not in MIXERS:
        raise _unported(kind)


def _pdict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


class Layer(nn.Module):
    """One layer: norm1 -> mixer (``attn`` for the attention kinds, ``ssd``,
    ``rglru``),
    in a decoder of an encoder-decoder config normx -> cross-attention
    ``xattn``, then norm2 -> dense ``mlp`` or ``moe`` when the config has an
    MLP, each residual.  The subtrees and their names are those of
    ``repro``'s layer params."""

    def __init__(self, kind: str, norm1: Dict, *, attn: Optional[Dict] = None,
                 ssd: Optional[Dict] = None, rglru: Optional[Dict] = None,
                 normx: Optional[Dict] = None,
                 xattn: Optional[Dict] = None, norm2: Optional[Dict] = None,
                 mlp: Optional[Dict] = None, moe: Optional[Dict] = None):
        super().__init__()
        mixers = {"attn": attn, "ssd": ssd, "rglru": rglru}
        held = sorted(k for k, v in mixers.items() if v is not None)
        if held != [MIXERS.get(kind)]:
            raise ValueError(f"a {kind!r} layer holds exactly its mixer; got {held}")
        if (normx is None) != (xattn is None):
            raise ValueError("normx comes with xattn")
        if (norm2 is None) != (mlp is None and moe is None) or \
                (mlp is not None and moe is not None):
            raise ValueError("norm2 comes with one of mlp and moe")
        self.kind = kind
        self.norm1 = _pdict(norm1)
        for name, sub in (*mixers.items(), ("normx", normx), ("xattn", xattn),
                          ("norm2", norm2), ("mlp", mlp)):
            setattr(self, name, _pdict(sub) if sub is not None else None)
        self.moe = MOE.MoE(**moe) if moe is not None else None


class Encoder(nn.Module):
    """The encoder of an encoder-decoder config (``repro``'s
    ``params["enc"]``): ``"enc"`` layers and a final norm."""

    def __init__(self, layers: List[Layer], final_norm: Dict):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = _pdict(final_norm)


class Transformer(nn.Module):
    """The parameters of the whole model (``repro``'s params pytree)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 layers: List[Layer], final_norm: Dict,
                 lm_head: Optional[torch.Tensor] = None,
                 enc: Optional[Encoder] = None):
        super().__init__()
        if (enc is not None) != cfg.is_encdec:
            raise ValueError(f"{cfg.name}: an encoder comes with enc_layers > 0")
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _pdict(final_norm)
        self.lm_head = nn.Parameter(lm_head) if lm_head is not None else None
        self.enc = enc

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ============================================================== init


def _init_attn(gen: torch.Generator, cfg: ModelConfig, device, dtype, tp: int = 1,
               cross: bool = False, kv_pad: bool = True) -> Dict:
    """Attention projections; a cross-attention's have no q/k/v bias.
    Query heads are padded to a multiple of ``tp`` and KV heads replicated
    to ``cfg.padded_kv_heads(tp)``, as in ``repro``; with ``kv_pad=False``
    the KV heads keep the config's count, unless the padded query heads do
    not group over it (then they are padded all the same)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq = cfg.padded_heads(tp)
    kv = cfg.padded_kv_heads(tp) if kv_pad else max(cfg.n_kv_heads, 1)
    if hq % kv:
        kv = cfg.padded_kv_heads(tp)     # integer GQA groups

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    s = 1.0 / math.sqrt(d)
    p = {"wq": normal((d, hq * hd), s), "wk": normal((d, kv * hd), s),
         "wv": normal((d, kv * hd), s),
         "wo": normal((hq * hd, d), 1.0 / math.sqrt(hq * hd))}
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", hq), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((width * hd,), dtype=dtype, device=device)
    return p


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, i: int, device,
                dtype, tp: int = 1, cross: bool = False, kv_pad: bool = True) -> Layer:
    """Layer ``i`` of kind ``kind``; ``cross`` adds normx and xattn (whose KV
    heads are padded whatever ``kv_pad`` says, as in ``repro``)."""
    _check_layer(kind)
    sub = {}
    if kind == "ssd":
        sub["ssd"] = SSM.init_ssd_block(gen, cfg, device, dtype)
    elif kind == "rglru":
        sub["rglru"] = RG.init_rglru_block(gen, cfg, device, dtype)
    else:
        sub["attn"] = _init_attn(gen, cfg, device, dtype, tp, kv_pad=kv_pad)
    if cross:
        sub["normx"] = L.init_norm(cfg.d_model, cfg.norm, device)
        sub["xattn"] = _init_attn(gen, cfg, device, dtype, tp, cross=True)
    if cfg.d_ff > 0:
        sub["norm2"] = L.init_norm(cfg.d_model, cfg.norm, device)
        if cfg.n_experts and i % cfg.moe_every == cfg.moe_every - 1:
            sub["moe"] = MOE.init_moe(gen, cfg, device, dtype)
        else:
            sub["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, device, dtype)
    return Layer(kind, L.init_norm(cfg.d_model, cfg.norm, device), **sub)


def init_params(cfg: ModelConfig, generator: torch.Generator, *, tp: int = 1,
                device="cuda", dtype=torch.bfloat16, kv_pad: bool = True) -> Transformer:
    """Random weights with the JAX package's shapes and scales, drawn from
    ``generator`` (which must live on ``device``) and made on ``device``.
    Attention heads are padded for ``tp``-way tensor parallelism as
    ``repro``'s ``init_params(cfg, key, tp)`` pads them (the full model;
    ``repro_torch.convert.shard_params`` cuts a rank's shards); with
    ``kv_pad=False`` the decoder's self-attention keeps its true KV head
    count, as ``repro``'s ``kvdedup`` decode cells hold it.  Norm
    parameters stay float32, as in ``repro``.  An encoder-decoder config
    also gets the encoder's ``"enc"`` layers."""
    device = torch.device(device)
    layers = [_init_layer(generator, cfg, cfg.pattern_at(i), i, device, dtype, tp,
                          cross=cfg.is_encdec, kv_pad=kv_pad)
              for i in range(cfg.num_layers)]
    enc = None
    if cfg.is_encdec:
        enc = Encoder([_init_layer(generator, cfg, "enc", i, device, dtype, tp)
                       for i in range(cfg.enc_layers)],
                      L.init_norm(cfg.d_model, cfg.norm, device))
    vp = cfg.padded_vocab()
    emb = (torch.randn((vp, cfg.d_model), generator=generator, device=device)
           * 0.02).to(dtype)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = (torch.randn((cfg.d_model, vp), generator=generator,
                               device=device) * 0.02).to(dtype)
    return Transformer(cfg, emb, layers,
                       L.init_norm(cfg.d_model, cfg.norm, device), lm_head, enc)


# ============================================================== training


def _axis(logical: str) -> Optional[Axis]:
    """The installed mesh's axis that the rules map ``logical`` to; None
    off a mesh."""
    mesh, rules = get_mesh(), get_rules()
    if mesh is None or rules is None or rules.get(logical) is None:
        return None
    return mesh_axis(mesh, rules[logical])


def _pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows in front of its sequence (dim 1) up to a
    multiple of ``n``."""
    pad = -x.shape[1] % n
    if not pad:
        return x
    return torch.cat([x.new_zeros((x.shape[0], pad) + x.shape[2:]), x], dim=1)


def _enter(x: torch.Tensor, sp: Optional[Axis], tp: Optional[Axis],
           s: Optional[int] = None) -> torch.Tensor:
    """A region's input from the residual stream ``x``: under sequence
    parallelism (``sp``) the whole sequence gathered from every rank's
    slice, its last ``s`` rows; then Megatron's *f* on ``tp``, the axis the
    region is tensor-parallel on (None: a region every rank computes
    whole).  A region tensor-parallel on ``sp`` itself is entered by the
    all-gather alone, whose backward reduce-scatters the partial
    gradients."""
    on_sp = sp is not None and tp is not None and tp.name == sp.name
    if sp is not None:
        x = ring_all_gather(x, sp, 1) if on_sp else gather_from(x, sp, 1)
    if s is not None:
        x = x[:, x.shape[1] - s:]
    return copy_to(x, tp) if tp is not None and not on_sp else x


def _leave(y: torch.Tensor, sp: Optional[Axis], tp: Optional[Axis]) -> torch.Tensor:
    """A region's output back into the residual stream: partial sums over
    ``tp`` are summed (a ``psum``, or under sequence parallelism on that
    axis a reduce-scatter to this rank's slice); a whole output is split
    to this rank's slice under sequence parallelism."""
    if sp is not None and tp is not None and tp.name == sp.name:
        return ring_reduce_scatter(_pad_front(y, sp.size), sp, 1)
    if tp is not None:
        y = psum(y, tp)
    return y if sp is None else split_to(_pad_front(y, sp.size), sp, 1)


def _norm(x: torch.Tensor, p, kind: str, sp: Optional[Axis]) -> torch.Tensor:
    """A norm of the residual stream.  Under sequence parallelism its
    scale and bias see only this rank's rows, so they enter through *f* on
    the axis: their gradients are summed over it."""
    if sp is not None:
        p = {k: copy_to(v, sp) for k, v in p.items()}
    return L.norm(x, p, kind)


def _lookup(model: Transformer, ids: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The embedding rows of ``ids``; under a vocabulary split over ``ax``
    this rank's masked local lookup (zeros for the ids it does not hold)."""
    if ax is None:
        return model.embed[ids]
    emb = model.embed
    vs = emb.shape[0]
    loc = ids - ax.index * vs
    ok = (loc >= 0) & (loc < vs)
    out = emb[loc.clamp(0, vs - 1)]
    return torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def embed_tokens(model: Transformer, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; under a mesh vocab-parallel: each model rank looks
    up the ids in its vocabulary slice (zeros elsewhere), and a ``psum``
    over the axis assembles the rows."""
    ax = _axis("vocab")
    out = _lookup(model, ids, ax)
    return out if ax is None else psum(out, ax)


def lm_loss(model: Transformer, x: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the next-token labels over the last
    ``labels.shape[1]`` rows of ``x`` (rows before them, a VLM's prefix,
    carry no label): float32 logits over the padded vocabulary, cut to
    ``vocab_size``, logsumexp minus the label's logit.

    Under a mesh, the fused vocab-parallel form of ``repro``: each model
    rank keeps its vocabulary slice of the logits, masks the padding
    (global ids >= ``vocab_size``) with -1e30, and the max (which carries
    no gradient), the sum of exps and the label's logit are reduced over
    the axis; the mean is over this rank's tokens (its data shard).  Under
    sequence parallelism ``x`` is this rank's slice of the sequence, as
    :func:`forward` returns it, and is all-gathered first."""
    w = model.lm_head if model.lm_head is not None else model.embed.T
    ax = _axis("vocab")
    x = _enter(x, seq_sp_axis(), ax, labels.shape[1])
    if ax is None:
        logits = (x @ w).float()[..., :model.cfg.vocab_size]
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(lse - lab)
    vs = w.shape[-1]
    off = ax.index * vs
    logits = (x @ w).float()                                       # (b, s, vs)
    gids = off + torch.arange(vs, device=logits.device)
    logits = torch.where(gids < model.cfg.vocab_size, logits,
                         torch.full((), -1e30, device=logits.device))
    mx = pmax(logits.detach().amax(-1), ax)                        # (b, s)
    se = psum(torch.exp(logits - mx[..., None]).sum(-1), ax)
    loc = labels.long() - off
    ok = (loc >= 0) & (loc < vs)
    lab = torch.gather(logits, -1, loc.clamp(0, vs - 1)[..., None])[..., 0]
    lab = psum(torch.where(ok, lab, torch.zeros((), device=lab.device)), ax)
    return torch.mean((mx + torch.log(se)) - lab)


def full_sequence(x: torch.Tensor, length: int) -> torch.Tensor:
    """The whole sequence of ``length`` rows from this rank's slice ``x``
    under sequence parallelism (gathered; the gradient of a consumer that
    every rank computes whole comes back to the slice), ``x`` itself
    without it."""
    sp = seq_sp_axis()
    return x if sp is None else _enter(x, sp, None, length)


def _attn_apply(p: nn.ParameterDict, cfg: ModelConfig, x: torch.Tensor,
                kind: str, positions: torch.Tensor, prefix_len: int = 0,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                sp: Optional[Axis] = None) -> torch.Tensor:
    """Full-sequence attention (train/prefill).  x: (B, S, d), or under
    sequence parallelism over ``sp`` this rank's slice of it.

    Self-attention is causal with RoPE, within ``cfg.window`` positions for
    ``"swa"`` and within chunks of ``cfg.window`` positions for
    ``"chunked"``, bidirectional within the first ``prefix_len`` positions;
    ``"enc"`` layers attend bidirectionally without RoPE.  With ``kv``, the
    (k, v) of a cross-attention, the queries attend to all of them, without
    RoPE.

    Under a mesh, p holds this rank's heads: x enters and the output
    projection's partial sum leaves as :func:`_enter` and :func:`_leave`
    say."""
    hd = cfg.head_dim
    hq = p["wq"].shape[-1] // hd
    kvh = p["wk"].shape[-1] // hd
    ax = _axis("heads")
    x = _enter(x, sp, ax, None if sp is None else positions.shape[1])
    b, s, _ = x.shape
    q = L.matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, hq, hd)
    if kv is not None:
        out = L.flash_attention(q, *kv, causal=False)
    else:
        k = L.matmul(x, p["wk"])
        v = L.matmul(x, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(b, s, kvh, hd)
        v = v.reshape(b, s, kvh, hd)
        if kind != "enc":
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        out = L.flash_attention(q, k, v, causal=kind != "enc", prefix_len=prefix_len,
                                **_mask(cfg, kind))
    y = L.matmul(out.reshape(b, s, hq * hd), p["wo"])
    return _leave(y, sp, ax)


def _enc_kv(layer: Layer, cfg: ModelConfig,
            enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This layer's cross-attention K and V (B, S_enc, Hkv, D), projected
    from the encoder output in the dtype ``x @ w`` promotes to."""
    xa = layer.xattn
    b, se, _ = enc_out.shape
    hd = cfg.head_dim
    kvh = xa["wk"].shape[-1] // hd
    ax = _axis("kv_heads")
    if ax is not None:
        enc_out = copy_to(enc_out, ax)
    return (L.matmul(enc_out, xa["wk"]).reshape(b, se, kvh, hd),
            L.matmul(enc_out, xa["wv"]).reshape(b, se, kvh, hd))


def _mask(cfg: ModelConfig, kind: str) -> Dict[str, int]:
    return {"window": cfg.window if kind == "swa" else 0,
            "chunk": cfg.window if kind == "chunked" else 0}


def _mlp_apply(layer: Layer, cfg: ModelConfig, x: torch.Tensor,
               moe_ctx: Optional[Dict] = None, sp: Optional[Axis] = None,
               s: Optional[int] = None) -> torch.Tensor:
    """The residual MLP half of a layer: dense, or MoE
    (:func:`_moe_dispatch`).  Under a mesh the dense MLP holds this rank's
    ``ff`` columns and rows, entered and left as :func:`_enter` and
    :func:`_leave` say; the MoE takes the whole sequence (``s`` rows)."""
    if layer.norm2 is None:
        return x
    h2 = _norm(x, layer.norm2, cfg.norm, sp)
    if layer.moe is not None:
        y = _moe_dispatch(layer.moe, cfg, _enter(h2, sp, None, s), moe_ctx or {})
        return x + _leave(y, sp, None)
    ax = _axis("ff")
    return x + _leave(L.mlp_apply(layer.mlp, _enter(h2, sp, ax, s), cfg.act), sp, ax)


def _moe_dispatch(p: MOE.MoE, cfg: ModelConfig, x: torch.Tensor,
                  moe_ctx: Dict) -> torch.Tensor:
    """The MoE layer on the model axis of the installed mesh, with
    ``moe_ctx``'s ``moe_impl``, ``a2a_impl`` and ``ar_impl``; the local
    capacity path off a mesh (``repro``'s ``_moe_dispatch``)."""
    ax = _axis("ff")
    if ax is None:
        return MOE.moe_apply_local(p, cfg, x, tp=1)
    return MOE.moe_apply_local(
        p, cfg, x, moe_impl=moe_ctx.get("moe_impl", "tp"),
        a2a_impl=moe_ctx.get("a2a_impl", "binary"), ar_impl=moe_ctx.get("ar_impl", "psum"),
        tp=ax.size, group=ax)


def _recurrent_apply(layer: Layer, cfg: ModelConfig, h: torch.Tensor,
                     sp: Optional[Axis], s: Optional[int],
                     cache: Optional[Dict[str, torch.Tensor]] = None,
                     live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An SSD or RG-LRU mixer on the normed residual ``h``: under a mesh
    tensor-parallel over ``ff`` (its heads over ``heads``, the same axis),
    entered and left as the dense MLP (:func:`_enter`, :func:`_leave`).
    With ``cache`` (decode) it advances the layer's state by one token and
    updates ``cache`` in place; under a mesh the state is this rank's share
    (its heads or channels), which advances alone.  With ``live`` ((B,)
    bool) a lane that is not live keeps its old state in every leaf."""
    ax = _axis("ff")
    hax = _axis("heads")
    if (ax is None) != (hax is None) or (ax is not None and ax.name != hax.name):
        raise ValueError(f"{layer.kind!r} layers split ff and heads over one axis; the "
                         f"rules map them to {get_rules().get('ff')!r} and "
                         f"{get_rules().get('heads')!r}")
    x = _enter(h, sp, ax, s)
    decode = cache is not None
    if layer.kind == "ssd":
        y, new = SSM.ssd_block_apply(layer.ssd, cfg, x, cache, decode=decode, axis=ax)
    else:
        y, new = RG.rglru_block_apply(layer.rglru, cfg, x, cache, decode=decode)
    if decode:
        if live is not None:
            new = {k: torch.where(live.view(-1, *(1,) * (v.dim() - 1)), v,
                                  cache[k].to(v.dtype)) for k, v in new.items()}
        cache.update(new)
    return _leave(y, sp, ax)


_SUBDICTS = ("norm1", "attn", "ssd", "rglru", "normx", "xattn", "norm2", "mlp")


def _fsdp_gather(layer: Layer, moe_impl: str):
    """``layer`` with every weight that the rules' ``fsdp`` axis splits
    ring all-gathered over it (a view of the layer's structure holding the
    gathered tensors); ``layer`` itself when the rules leave ``fsdp``
    unmapped.  A dimension split over several mesh axes is gathered minor
    axis first, undoing ``shard_tensor``'s major-to-minor cut."""
    spec = resolve(("fsdp",))
    if not spec or spec[0] is None:
        return layer
    names = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    axes = [ax for ax in (mesh_axis(get_mesh(), n) for n in reversed(names)) if ax.size > 1]
    if not axes:
        return layer
    full = {}
    for name, p in layer.named_parameters():
        dim = fsdp_dim(name, p.dim(), moe_impl)
        if dim is not None:
            for ax in axes:
                p = ring_all_gather(p, ax, dim)
        full[name] = p

    def sub(mod, prefix):
        return None if mod is None else {k: full[f"{prefix}.{k}"] for k in mod.keys()}

    view = SimpleNamespace(kind=layer.kind, moe=None,
                           **{n: sub(getattr(layer, n), n) for n in _SUBDICTS})
    if layer.moe is not None:
        m = layer.moe
        view.moe = SimpleNamespace(
            router=full["moe.router"], w_up=full["moe.w_up"], w_down=full["moe.w_down"],
            w_gate=full.get("moe.w_gate"), shared=sub(m.shared, "moe.shared"))
    return view


def _layer_apply(layer: Layer, cfg: ModelConfig, x: torch.Tensor,
                 positions: Optional[torch.Tensor], prefix_len: int = 0,
                 enc_out: Optional[torch.Tensor] = None,
                 moe_ctx: Optional[Dict] = None, sp: Optional[Axis] = None) -> torch.Tensor:
    layer = _fsdp_gather(layer, (moe_ctx or {}).get("moe_impl", "tp"))
    s = None if sp is None else positions.shape[1]
    h = _norm(x, layer.norm1, cfg.norm, sp)
    if layer.kind in ("ssd", "rglru"):
        x = x + _recurrent_apply(layer, cfg, h, sp, s)
    else:
        x = x + _attn_apply(layer.attn, cfg, h, layer.kind, positions, prefix_len, sp=sp)
    if layer.xattn is not None and enc_out is not None:
        hx = _norm(x, layer.normx, cfg.norm, sp)
        x = x + _attn_apply(layer.xattn, cfg, hx, "attn", positions,
                            kv=_enc_kv(layer, cfg, enc_out), sp=sp)
    return _mlp_apply(layer, cfg, x, moe_ctx, sp, s)


def forward(model: Transformer, batch: Dict[str, torch.Tensor], *,
            moe_ctx: Optional[Dict] = None, remat: bool = True) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, d), or (B, P + S, d)
    for a VLM config given ``batch["patches"]`` (B, P, d): the patches, cast
    to the activations' dtype, come first, and attention is bidirectional
    within the first ``cfg.prefix_len`` positions.  An encoder-decoder
    config given ``batch["frames"]`` (B, S_enc, d) encodes them
    (:func:`encode`) and every decoder layer cross-attends to the result.
    As in ``repro``, ``patches`` and ``frames`` are ignored by configs
    without a prefix or an encoder.  ``moe_ctx`` holds the MoE layers'
    ``moe_impl``, ``a2a_impl`` and ``ar_impl`` under a mesh.  Under
    sequence parallelism the result is this rank's slice of the sequence
    (``ceil(S / n)`` rows of an axis of ``n`` ranks; :func:`lm_loss` takes
    it as it is, :func:`full_sequence` gathers it).

    With ``remat`` each decoder layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as JAX wraps each group in ``jax.checkpoint`` with
    nothing saveable: only the layer inputs stay alive, and each layer's
    forward, its flash-attention or SSD-scan kernels or its RG-LRU scan
    included, runs again
    during the backward pass.  The encoder is not recomputed, as JAX's
    ``encode`` scans its layers without a checkpoint."""
    cfg = model.cfg
    sp = seq_sp_axis()
    prefix = cfg.prefix_len and "patches" in batch
    if sp is None:
        x = embed_tokens(model, batch["tokens"])
        if prefix:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    else:
        # the partial lookups (and the prefix, joined on the vocabulary
        # axis's first rank) reduce-scatter straight into the slices
        vax = _axis("vocab")
        x = _lookup(model, batch["tokens"], vax)
        if prefix:
            pre = batch["patches"].to(x.dtype)
            if vax is not None and vax.index:
                pre = torch.zeros_like(pre)
            x = torch.cat([pre, x], dim=1)
    b, s, _ = x.shape
    if sp is not None:
        x = _leave(x, sp, vax)
    prefix_len = cfg.prefix_len if prefix else 0
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc_out = None
    if cfg.is_encdec and "frames" in batch:
        enc_out = encode(model, batch["frames"])
    for layer in model.layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer_apply, layer, cfg, x, positions, prefix_len, enc_out,
                           moe_ctx, sp, use_reentrant=False)
        else:
            x = _layer_apply(layer, cfg, x, positions, prefix_len, enc_out, moe_ctx, sp)
    return _norm(x, model.final_norm, cfg.norm, sp)


def _sinusoid_positions(s: int, d: int, device) -> torch.Tensor:
    """(S, d) float32 sinusoidal positions: sin of pos / 10000^(2i/d) in the
    first half of the columns, cos in the second, as ``repro``'s encoder."""
    pos = torch.arange(s, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over stub frame embeddings (B, S_enc, d):
    sinusoidal positions added in the frames' dtype, the ``"enc"`` layers
    (no RoPE, no mask), a final norm.  Float32 frames keep it in float32."""
    cfg = model.cfg
    if model.enc is None:
        raise ValueError(f"{cfg.name} has no encoder")
    _, s, d = frames.shape
    x = frames + _sinusoid_positions(s, d, frames.device).to(frames.dtype)[None]
    for layer in model.enc.layers:
        x = _layer_apply(layer, cfg, x, None)
    return L.norm(x, model.enc.final_norm, cfg.norm)


# ============================================================== serving


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind in ("swa", "chunked") and cfg.window:
        return min(cfg.window, max_len)
    return max_len


def _seq_axis(seq_sharded: bool) -> Optional[Axis]:
    """The axis a sequence-sharded cache is split over (the rules'
    ``seq_shard``); None for a cache that is not."""
    if not seq_sharded:
        return None
    ax = _axis("seq_shard")
    if ax is None:
        raise ValueError("a sequence-sharded cache needs a mesh and rules that map seq_shard")
    return ax


def init_cache(model: Transformer, batch: int, max_len: int,
               dtype=torch.bfloat16, *, seq_sharded: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Zeroed caches, one dict per layer, on the model's device: for an
    attention layer ``k`` and ``v`` (B, W, Hkv, D) in ``dtype`` and ``pos``
    (B, W) int32, -1 = empty; for an SSD layer its state and conv caches
    (:func:`repro_torch.models.ssm.init_ssd_cache`), for an RG-LRU layer
    its ``h`` and conv cache in ``dtype``
    (:func:`repro_torch.models.rglru.init_rglru_cache`); for a layer with
    cross-attention also ``xk`` and ``xv`` (B, S_enc, Hkv, D) in ``dtype``,
    which :func:`encode_to_cache` replaces.

    Under a mesh each rank holds its shard, as ``cache_pspecs`` in
    :mod:`repro_torch.parallel.specs` lays the cache out: ``batch`` is this
    rank's lanes, and the heads, states and channels are those of the
    rank's weights.  With ``seq_sharded`` every attention layer's slots are
    split over the rules' ``seq_shard`` axis too: a rank holds W / n of
    them (n the axis's size, which must divide W)."""
    cfg = model.cfg
    hd = cfg.head_dim
    dev = model.device
    sax = _seq_axis(seq_sharded)
    cache = []
    for layer in model.layers:
        if layer.kind == "ssd":
            c = SSM.init_ssd_cache(cfg, batch, dtype, dev, p=layer.ssd)
        elif layer.kind == "rglru":
            c = RG.init_rglru_cache(cfg, batch, dtype, dev, p=layer.rglru)
        else:
            kvh = layer.attn["wk"].shape[-1] // hd
            wc = _cache_len(cfg, layer.kind, max_len)
            if sax is not None:
                if wc % sax.size:
                    raise ValueError(f"a {layer.kind!r} cache of {wc} slots does not split "
                                     f"over {sax.size} ranks of {sax.name!r}")
                wc //= sax.size
            c = {"k": torch.zeros((batch, wc, kvh, hd), dtype=dtype, device=dev),
                 "v": torch.zeros((batch, wc, kvh, hd), dtype=dtype, device=dev),
                 "pos": torch.full((batch, wc), -1, dtype=torch.int32, device=dev)}
        if layer.xattn is not None:
            kvh = layer.xattn["wk"].shape[-1] // hd
            for name in ("xk", "xv"):
                c[name] = torch.zeros((batch, cfg.enc_seq, kvh, hd), dtype=dtype, device=dev)
        cache.append(c)
    return cache


def _local_kv(t: torch.Tensor, hax: Optional[Axis], kax: Optional[Axis]) -> torch.Tensor:
    """The KV heads (dim 2) of ``t`` that this rank's query heads read: all
    of them unless the query heads are split over ``hax`` while the rules
    leave the KV heads whole (``kax`` unmapped or another axis); then the
    rank's share, which holds exactly its query heads' groups when the KV
    heads are padded for the axis."""
    if hax is None or hax.size == 1 or (kax is not None and kax.name == hax.name):
        return t
    n = t.shape[2]
    if n % hax.size:
        raise ValueError(f"{n} replicated KV heads do not split over the {hax.size} ranks "
                         f"that split the query heads")
    return t.narrow(2, hax.index * (n // hax.size), n // hax.size)


def _write_slot(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                position: torch.Tensor, sax: Optional[Axis]) -> None:
    """Write one token's k and v (B, Hkv, D) at ``position`` (B,) into the
    ring-buffer cache in place: position ``t`` goes to slot ``t % W``, as in
    ``repro``.  Over a sequence axis ``sax`` the ring of W = n * W_local
    slots is split in n runs of W_local, rank r holding slots [r W_local,
    (r + 1) W_local): the rank that holds slot ``t % W`` writes it at
    ``(t % W) % W_local``, the others write back what the slot held, so no
    rank needs to know on the host whose turn it is."""
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    bi = torch.arange(kc.shape[0], device=kc.device)
    if sax is None:
        slot = (position % kc.shape[1]).long()
        kc.index_put_((bi, slot), k.to(kc.dtype))
        vc.index_put_((bi, slot), v.to(vc.dtype))
        pc.index_put_((bi, slot), position)
        return
    wl = kc.shape[1]
    g = (position % (wl * sax.size)).long()
    own = torch.div(g, wl, rounding_mode="floor") == sax.index
    slot = g % wl
    kc.index_put_((bi, slot), torch.where(own[:, None, None], k.to(kc.dtype), kc[bi, slot]))
    vc.index_put_((bi, slot), torch.where(own[:, None, None], v.to(vc.dtype), vc[bi, slot]))
    pc.index_put_((bi, slot), torch.where(own, position, pc[bi, slot]))


def _attn_decode(p: nn.ParameterDict, cfg: ModelConfig, x: torch.Tensor,
                 kind: str, position: torch.Tensor, cache: Dict[str, torch.Tensor],
                 sax: Optional[Axis] = None) -> torch.Tensor:
    """One-token attention against the layer's ring-buffer cache.

    x: (B, 1, d); position: (B,) int32 absolute positions on the device.
    Position ``t`` goes to slot ``t % W``, as in ``repro``, so a sequence
    longer than the cache attends to its last W positions.  The cache is
    updated in place (``index_put_``), where JAX builds a new one with
    ``.at[].set``.  ``"swa"`` and ``"chunked"`` layers mask by ``cfg.window``
    as in :func:`_attn_apply`.

    Under a mesh p holds this rank's query heads (``heads``) and its KV
    heads (``kv_heads``; all of them where the rules leave those whole), the
    cache the rank's KV heads, and the output projection's partial sum is
    summed over the heads' axis.  Over ``sax``, the axis of a
    sequence-sharded cache, each rank attends to its slots in the
    log-sum-exp form of the kernel and the partial rows are merged across
    the axis (:func:`~repro_torch.models.layers.merge_partials`); when the
    query heads are split over that same axis (``kvdedup``: the KV heads
    whole, the sequence over ``model``) every rank first gathers all the
    query heads (B x Hq x D, one token), and keeps its own after the merge.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    hq = p["wq"].shape[-1] // hd
    kvh = p["wk"].shape[-1] // hd
    hax = _axis("heads")
    x = _enter(x, None, hax)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos_b = position[:, None]
    q = L.apply_rope(q.reshape(b, 1, hq, hd), pos_b, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, 1, kvh, hd), pos_b, cfg.rope_theta)
    v = v.reshape(b, 1, kvh, hd)
    _write_slot(cache, k[:, 0], v[:, 0], position, sax)

    gathered = sax is not None and hax is not None and hax.name == sax.name
    kc, vc = cache["k"], cache["v"]
    if not gathered:
        kax = _axis("kv_heads")
        kc, vc = _local_kv(kc, hax, kax), _local_kv(vc, hax, kax)
    if sax is None:
        out = decode_attention_cache(q, kc, vc, cache["pos"], position,
                                     **_mask(cfg, kind))          # (B, 1, Hq, D)
    else:
        if gathered:
            q = ring_all_gather(q.contiguous(), hax, 2)
        part, lse = decode_attention_cache(q, kc, vc, cache["pos"], position,
                                           return_lse=True, **_mask(cfg, kind))
        out = L.merge_partials(part, lse, sax, q.dtype)
        if gathered:
            out = out.narrow(2, hax.index * hq, hq)
    return _leave(out.reshape(b, 1, hq * hd) @ p["wo"], None, hax)


def _cross_decode(p: nn.ParameterDict, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], lengths: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention to every key of the cache's ``xk``/``xv``:
    flash-decode's lengths form, each lane's length (``lengths``, (B,)
    int32) the whole encoder sequence.  x: (B, 1, d).  Under a mesh
    tensor-parallel over ``heads``, as :func:`_attn_decode`."""
    b = x.shape[0]
    hd = cfg.head_dim
    hq = p["wq"].shape[-1] // hd
    hax, kax = _axis("heads"), _axis("kv_heads")
    x = _enter(x, None, hax)
    q = L.matmul(x, p["wq"]).reshape(b, hq, hd)
    out = decode_attention(q, _local_kv(cache["xk"], hax, kax),
                           _local_kv(cache["xv"], hax, kax), lengths)   # (B, Hq, D)
    return _leave(L.matmul(out.reshape(b, 1, hq * hd), p["wo"]), None, hax)


def _layer_decode(layer: Layer, cfg: ModelConfig, x: torch.Tensor,
                  position: torch.Tensor, cache: Dict[str, torch.Tensor],
                  xlen: Optional[torch.Tensor] = None, moe_ctx: Optional[Dict] = None,
                  sax: Optional[Axis] = None,
                  live: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = L.norm(x, layer.norm1, cfg.norm)
    if layer.kind in ("ssd", "rglru"):
        # the live lanes advance their state by one token, the others keep it
        x = x + _recurrent_apply(layer, cfg, h, None, None, cache, live)
    else:
        x = x + _attn_decode(layer.attn, cfg, h, layer.kind, position, cache, sax)
    if layer.xattn is not None and "xk" in cache:
        x = x + _cross_decode(layer.xattn, cfg, L.norm(x, layer.normx, cfg.norm), cache,
                              xlen)
    # every lane, idle and paused ones too, goes through an MoE router and
    # competes for expert capacity, as in repro
    return _mlp_apply(layer, cfg, x, moe_ctx)


def greedy_tokens(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """The argmax of the logits of the final hidden rows ``x`` (B, d) over
    the real vocabulary, as (B,) int32: float32 logits, the padded ids
    masked with -inf.  Under a vocabulary split each model rank scores its
    slice; the best score and then the least id that reaches it are reduced
    over the axis, so ties go to the first maximum, as ``jnp.argmax``
    takes it."""
    w = model.lm_head if model.lm_head is not None else model.embed.T
    logits = (x @ w).float()                                       # (B, vocab slice)
    ax = _axis("vocab")
    off = 0 if ax is None else ax.index * w.shape[-1]
    ids = off + torch.arange(w.shape[-1], device=logits.device)
    logits = logits.masked_fill(ids[None] >= model.cfg.vocab_size, -float("inf"))
    if ax is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    best, at = logits.max(dim=-1)
    top = pmax(best, ax)
    big = torch.iinfo(torch.int64).max
    cand = torch.where(best == top, at + off, torch.full_like(at, big))
    return (-pmax(-cand, ax)).to(torch.int32)


def _step_inputs(tokens, position, dev: torch.device, live=None):
    """(tokens int64 (B,), positions int32 (B,), the lane mask bool (B,) or
    None) on ``dev``: tensors already there are taken as they are; host
    arrays go over in one copy from pinned memory that does not wait for
    the card."""
    given = [t for t in (tokens, position, live) if t is not None]
    if all(isinstance(t, torch.Tensor) and t.device == dev for t in given):
        return (tokens.reshape(-1).to(torch.int64), position.reshape(-1).to(torch.int32),
                None if live is None else live.reshape(-1).bool())
    host = np.concatenate([np.asarray(t, np.int64).reshape(-1) for t in given])
    both = torch.from_numpy(host)
    if dev.type == "cuda":      # a pinned source lets the copy skip the wait
        both = both.pin_memory()
    both = both.to(dev, non_blocking=True).view(len(given), -1)
    return both[0], both[1].to(torch.int32), None if live is None else both[2].bool()


@torch.no_grad()
def decode_step(model: Transformer, cache: List[Dict[str, torch.Tensor]],
                tokens, position, *, moe_ctx: Optional[Dict] = None,
                seq_sharded: bool = False,
                live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, List[Dict]]:
    """One serving step: (B, 1) tokens at (B,) positions -> (B,) int32 next
    tokens on the model's device, plus the cache (updated in place).

    ``tokens`` and ``position`` are host integer arrays (numpy or CPU
    tensors), as the serving engine keeps them, which go to the device in
    one copy that does not wait for it, or tensors already on the model's
    device (``meta`` ones in the dry run); so the step itself needs no
    host-device sync, and nothing in it depends on the positions' values
    on the host.  An SSD or RG-LRU layer's state has no positions: each call
    advances every lane by one token, unless ``live`` ((B,) bool, like the
    tokens a host array or a tensor on the model's device) is given: then
    a lane that is not live keeps the old value of every leaf of every
    recurrent layer's state (its next token is computed all the same and
    may be ignored).  Attention layers take no
    mask: a lane that is not live rewrites the slot of its position, which
    its next live step writes again.  ``None`` advances every lane; a host
    mask goes over in the tokens' copy.

    Under a mesh (``parallel_rules``) each rank runs the step on its shards,
    its lanes (``batch``) and its cache (:func:`init_cache` with the same
    ``seq_sharded``): attention, MLP, MoE (``moe_ctx`` holds ``moe_impl``,
    ``a2a_impl`` and ``ar_impl``), SSD and RG-LRU layers tensor-parallel over
    the model axis, the logits vocab-parallel (:func:`greedy_tokens`); with
    ``seq_sharded`` each attention layer's cache is split over the rules'
    ``seq_shard`` axis and its partial attentions merged across it.  A step
    has one token a lane, so the rules' ``seq_sp`` plays no part in it.
    ``live`` is then this rank's slice of the lanes.
    """
    cfg = model.cfg
    dev = model.device
    sax = _seq_axis(seq_sharded)
    tok, pos, live = _step_inputs(tokens, position, dev, live)
    x = embed_tokens(model, tok[:, None])                    # (B, 1, d)
    # every lane attends to all the encoder's keys: one lengths tensor a step
    # serves every layer's cross-attention
    xlen = next((torch.full((tok.shape[0],), c["xk"].shape[1], dtype=torch.int32,
                            device=dev) for c in cache if "xk" in c), None)
    for layer, c in zip(model.layers, cache):
        x = _layer_decode(layer, cfg, x, pos, c, xlen, moe_ctx, sax, live)
    x = L.norm(x, model.final_norm, cfg.norm)
    return greedy_tokens(model, x[:, 0]), cache


@torch.no_grad()
def encode_to_cache(model: Transformer, cache: List[Dict[str, torch.Tensor]],
                    frames) -> List[Dict[str, torch.Tensor]]:
    """Run the encoder over ``frames`` (B, S_enc, d; moved to the model's
    device) and replace every decoder layer's ``xk`` and ``xv`` with its
    cross K/V projections, in the dtype those take (float32 for float32
    frames, as in ``repro``).  Call once per batch of utterances before
    :func:`decode_step`; returns the cache, updated in place."""
    enc_out = encode(model, torch.as_tensor(frames).to(model.device))
    for layer, c in zip(model.layers, cache):
        if layer.xattn is not None:
            c["xk"], c["xv"] = _enc_kv(layer, model.cfg, enc_out)
    return cache
