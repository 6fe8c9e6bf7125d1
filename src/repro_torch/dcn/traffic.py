"""DCN traffic volumes: DP/TP byte ratios recomputed from model configs.

Fig. 17's cross-ToR *volume* share weighs every DP-ring pair against the
HBD bytes each TP member moves.  Instead of a hand-set 9:1 ratio, this
module derives both volumes from the same Megatron-style communication
formulas the analytic MFU simulator uses (``repro_torch.core.mfu_sim.simulate``,
Table 3), so the traffic tables and the MFU tables stay consistent:

  * TP: 4 ring all-reduces per layer per microbatch, ``2X(t-1)/t`` bytes
    per GPU each;
  * DP: one gradient ring all-reduce per step, ``2G(d-1)/d`` bytes per
    ring link (bf16 gradients of the per-GPU parameter shard).

A copy of ``repro.dcn.traffic``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..core.mfu_sim import SimModel

#: Llama-3-70B-class dense config (the Fig. 17 caption's workload scale).
LLAMA3_70B = SimModel(
    name="llama3-70b", layers=80, hidden=8192, ffn=28672, vocab=128256,
    heads=64, seq=8192, ffn_mats=3,
)


def dp_tp_bytes(model: SimModel, tp: int, dp: int, *,
                pp: int = 1, global_batch: Optional[int] = None,
                micro_batch: int = 1,
                bytes_per_elem: int = 2) -> Tuple[float, float]:
    """Per-step ``(dp_bytes, tp_bytes)`` for the traffic-share weighting.

    ``tp_bytes`` is the HBD volume one TP-group member moves per training
    step (4 ring all-reduces x 2X(t-1)/t per layer per microbatch, summed
    over the step's microbatches); ``dp_bytes`` is the DCN volume one
    DP-ring link carries per step (ring all-reduce of the bf16 gradient
    shard, 2G(d-1)/d).  Both mirror ``repro_torch.core.mfu_sim.simulate``.

    ``global_batch`` defaults to ``dp * micro_batch`` -- one microbatch per
    DP step, the Fig. 17 calibration: for a Llama-3-70B-class model at
    TP-32 it lands within 10% of the paper's hand-set 9:1 ratio (the
    baseline plateau near 10%).  Larger global batches run more TP
    microbatches per gradient all-reduce, shrinking the DCN share further.
    """
    if tp < 1 or dp < 1 or pp < 1:
        raise ValueError("tp/dp/pp must be >= 1")
    if global_batch is None:
        global_batch = dp * micro_batch
    x_bytes = micro_batch * model.seq * model.hidden * bytes_per_elem
    micro_steps = max(global_batch // (dp * micro_batch), 1)
    tp_bytes = 0.0
    if tp > 1:
        tp_bytes = 4 * 2 * x_bytes * (tp - 1) / tp * model.layers * micro_steps
    dp_bytes = 0.0
    if dp > 1:
        grad_bytes = bytes_per_elem * model.params / (tp * pp)
        dp_bytes = 2 * grad_bytes * (dp - 1) / dp
    return dp_bytes, tp_bytes


def dp_tp_ratio(model: SimModel, tp: int, dp: int, **kw) -> float:
    """``tp_bytes / dp_bytes`` (the "9" in the historical 9:1 default)."""
    dp_b, tp_b = dp_tp_bytes(model, tp, dp, **kw)
    return tp_b / dp_b if dp_b else float("inf")


__all__ = ["LLAMA3_70B", "dp_tp_bytes", "dp_tp_ratio"]
