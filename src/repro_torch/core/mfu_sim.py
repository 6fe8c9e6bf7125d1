"""Analytic LLM-training MFU simulator (paper §6.3, Tables 2/4/5).

This is the paper's "in-house LLM training simulator": an analytic
performance model over (TP, PP, DP, EP) that accounts for

  * GEMM efficiency loss as TP slices matrices thinner (§6.3, [53]),
  * TP ring-allreduce time on the HBD (Table 3 volumes),
  * EP all-to-all time on the HBD (Table 3) plus the expert-imbalance
    straggler factor (Table 4),
  * pipeline bubbles (1F1B with optional virtual stages),
  * DP gradient all-reduce and PP activation traffic on the DCN,
  * a memory-capacity feasibility filter (bf16 + ZeRO-1 optimizer sharding).

MFU = useful model FLOPs / (GPUs x peak x wall time).  The same comm-volume
formulas feed ``orchestrator.cross_tor_traffic`` so Fig. 17 uses consistent
DP:TP ratios.

A copy of ``repro.core.mfu_sim``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SimModel:
    """Model description for the analytic simulator."""

    name: str
    layers: int
    hidden: int
    ffn: int
    vocab: int
    heads: int
    seq: int
    # MoE
    num_experts: int = 1
    top_k: int = 1
    moe_ratio: float = 0.0        # fraction of layers that are MoE
    ffn_mats: int = 2             # 2 = GELU MLP, 3 = SwiGLU
    tied_embeddings: bool = False

    @property
    def params(self) -> float:
        h, f = self.hidden, self.ffn
        attn = 4 * h * h
        dense_mlp = self.ffn_mats * h * f
        moe_mlp = self.num_experts * self.ffn_mats * h * f
        n_moe = self.layers * self.moe_ratio
        n_dense = self.layers - n_moe
        emb = self.vocab * h * (1 if self.tied_embeddings else 2)
        return (attn + dense_mlp) * n_dense + (attn + moe_mlp) * n_moe + emb

    def fwd_flops_per_token(self) -> float:
        """Active-path forward FLOPs per token (2 x active params touched +
        attention score/context terms)."""
        h, f, s = self.hidden, self.ffn, self.seq
        attn_proj = 2 * 4 * h * h
        attn_score = 2 * 2 * s * h          # QK^T + AV, causal halves then x2
        dense_mlp = 2 * self.ffn_mats * h * f
        moe_mlp = self.top_k * 2 * self.ffn_mats * h * f
        n_moe = self.layers * self.moe_ratio
        n_dense = self.layers - n_moe
        logits = 2 * h * self.vocab
        return ((attn_proj + attn_score + dense_mlp) * n_dense
                + (attn_proj + attn_score + moe_mlp) * n_moe + logits)

    def train_flops_per_token(self) -> float:
        return 3.0 * self.fwd_flops_per_token()


@dataclasses.dataclass(frozen=True)
class Cluster:
    """H100-class cluster per §6.1."""

    gpus: int
    peak_flops: float = 989e12        # H100 bf16 dense
    hbd_gbps: float = 800.0           # 6.4 Tbps per GPU (8x OCSTrx)
    dcn_gbps: float = 50.0            # ConnectX-7 400 Gbps
    hbm_bytes: float = 80e9
    max_tp: Optional[int] = None      # architecture HBD limit (e.g. 8 for DGX)


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    tp: int
    pp: int
    dp: int
    ep: int = 1
    vpp: int = 1
    micro_batch: int = 1


@dataclasses.dataclass
class SimResult:
    plan: ParallelPlan
    mfu: float
    step_time_s: float
    breakdown: Dict[str, float]


# GEMM efficiency model: a GEMM whose per-GPU inner dimension is x reaches
# peak_eff * x/(x + half_sat): TP-8 on h=16k is nearly free, TP-64 pays
# ~20%, consistent with [53]-style utilization curves.  Calibrated so the
# Table-2 anchor (1024 GPUs, TP-16) lands at MFU ~0.52.
GEMM_PEAK_EFF = 0.65
GEMM_HALF_SAT = 256.0


def gemm_eff(per_gpu_dim: float) -> float:
    return GEMM_PEAK_EFF * per_gpu_dim / (per_gpu_dim + GEMM_HALF_SAT)


def simulate(model: SimModel, cluster: Cluster, plan: ParallelPlan,
             global_batch: int = 2048, imbalance: float = 0.0,
             dp_overlap: float = 0.8, bytes_per_elem: int = 2) -> Optional[SimResult]:
    """Estimate step time & MFU for one parallelism plan.

    Returns None if the plan is infeasible (shape or memory constraints).
    """
    t, pp, d, e = plan.tp, plan.pp, plan.dp, plan.ep
    if t * pp * d != cluster.gpus:
        return None
    if cluster.max_tp and t > cluster.max_tp:
        return None
    if pp > model.layers or global_batch % d:
        return None
    if e > 1 and (model.num_experts % e or model.moe_ratio == 0.0):
        return None

    mbs = plan.micro_batch
    m = global_batch // (d * mbs)               # microbatches in flight
    if m < 1:
        return None
    tokens_mb = mbs * model.seq
    # uneven stage split allowed: the heaviest stage paces the pipeline
    layers_stage = math.ceil(model.layers / pp)

    # ---- memory feasibility (bf16 params+grads on t*pp shards; ZeRO-1
    # optimizer states additionally sharded over d; expert weights further
    # sharded over the EP group; activations with selective recompute, pp
    # microbatches resident).
    h_, f_ = model.hidden, model.ffn
    expert_params = (model.layers * model.moe_ratio) * model.num_experts * \
        model.ffn_mats * h_ * f_
    p_shard = (model.params - expert_params) / (t * pp) + \
        expert_params / (t * pp * e)
    weights = 4 * p_shard + 12 * p_shard / d
    act = layers_stage * pp * tokens_mb * model.hidden * 10 / t
    if weights + act > cluster.hbm_bytes * 0.92:
        return None

    # ---- per-microbatch per-stage compute
    h, f = model.hidden, model.ffn
    eff = gemm_eff(max(f / t, h / t))
    flops_stage_mb = model.train_flops_per_token() * tokens_mb * layers_stage / model.layers
    # logits layer lives on the last stage; amortize across stages for simplicity
    t_compute = flops_stage_mb / (t * cluster.peak_flops * eff)
    # expert imbalance stretches MoE expert compute (EP only; TP shards evenly)
    if e > 1 and imbalance > 0.0:
        moe_flops_layer = model.moe_ratio * model.top_k * 2 * model.ffn_mats * h * f
        avg_layer_flops = model.fwd_flops_per_token() / model.layers
        moe_frac = min(max(moe_flops_layer / avg_layer_flops, 0.0), 1.0)
        t_compute *= (1.0 - moe_frac) + moe_frac / (1.0 - imbalance)

    # ---- TP ring-allreduce on HBD (Table 3): 4 allreduces per layer per
    # microbatch (2 fwd + 2 bwd), ring cost 2X(t-1)/t per GPU.
    x_bytes = tokens_mb * h * bytes_per_elem
    t_tp = 0.0
    if t > 1:
        vol = 4 * 2 * x_bytes * (t - 1) / t * layers_stage
        t_tp = vol / (cluster.hbd_gbps * 1e9)

    # ---- EP all-to-all on HBD (Table 3): 4 ops per MoE layer per microbatch.
    t_ep = 0.0
    if e > 1:
        moe_layers_stage = layers_stage * model.moe_ratio
        vol = 4 * x_bytes * (e - 1) / e * (model.top_k / e) * moe_layers_stage
        t_ep = vol / (cluster.hbd_gbps * 1e9)

    stage_mb = t_compute + t_tp + t_ep

    # ---- pipeline: 1F1B with vpp virtual stages
    bubble = (pp - 1) / (plan.vpp * m)
    t_pipe = stage_mb * m * (1.0 + bubble)

    # ---- PP activation p2p on DCN (overlapped, pay the exposed tail)
    t_pp = 0.0
    if pp > 1:
        t_pp = (1 - dp_overlap) * 2 * m * x_bytes / (cluster.dcn_gbps * 1e9)

    # ---- DP gradient ring-allreduce on DCN (bf16 grads, partially hidden)
    t_dp = 0.0
    if d > 1:
        grad_bytes = 2 * p_shard
        vol = 2 * grad_bytes * (d - 1) / d
        t_dp = (1 - dp_overlap) * vol / (cluster.dcn_gbps * 1e9)

    step = t_pipe + t_pp + t_dp
    useful = model.train_flops_per_token() * global_batch * model.seq
    mfu = useful / (cluster.gpus * cluster.peak_flops * step)
    return SimResult(plan, mfu, step, {
        "compute": t_compute * m, "tp_comm": t_tp * m, "ep_comm": t_ep * m,
        "bubble": stage_mb * m * bubble, "dp_comm": t_dp, "pp_comm": t_pp,
        "gemm_eff": eff,
    })


def _pow2s(lo: int, hi: int) -> List[int]:
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def search(model: SimModel, cluster: Cluster, global_batch: int = 2048,
           tps: Iterable[int] = None, pps: Iterable[int] = None,
           eps: Iterable[int] = (1,), imbalance: float = 0.0,
           vpp: int = 1, max_dp: int = 1024) -> Optional[SimResult]:
    """Grid-search the best plan (the paper's footnote 6 search space)."""
    tps = list(tps) if tps else _pow2s(1, 128)
    pps = list(pps) if pps else _pow2s(1, 16)
    best: Optional[SimResult] = None
    for t in tps:
        for pp in pps:
            if cluster.gpus % (t * pp):
                continue
            d = cluster.gpus // (t * pp)
            if d > max_dp:
                continue
            for e in eps:
                res = simulate(model, cluster, ParallelPlan(t, pp, d, e, vpp),
                               global_batch, imbalance)
                if res and (best is None or res.mfu > best.mfu):
                    best = res
    return best


# ---------------------------------------------------------------- presets

LLAMA31_405B = SimModel(
    # Paper footnote 5 simplifies GQA to MHA to allow large TP.
    name="llama3.1-405b", layers=126, hidden=16384, ffn=53248, vocab=128256,
    heads=128, seq=8192, ffn_mats=3,
)

GPT_MOE_1T = SimModel(
    # Appendix B configuration (1.1T parameters).
    name="gpt-moe-1.1t", layers=192, hidden=12288, ffn=49152, vocab=64000,
    heads=128, seq=2048, num_experts=8, top_k=2, moe_ratio=0.5, ffn_mats=2,
)
