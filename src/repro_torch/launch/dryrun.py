"""Multi-pod dry run of the port: trace every (arch x shape x mesh) cell.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell's step for 256 or 512 TPU devices.  Here one process runs the
real train, prefill or decode step as rank 0 of a 256- or 512-rank world
that exists only as a fake process group
(:func:`repro_torch.parallel.mesh.fake_world`), on the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`), with every tensor
on the ``meta`` device: shapes and dtypes, no storage, nothing computed.
The kernel wrappers and the wire primitives take ``meta`` tensors, so the
step runs exactly the code it runs on the card.  Under
:class:`repro_torch.launch.op_analysis.OpAnalysis` it records, per rank:

  * ``memory``: ``argument_bytes`` (the rank's parameters, optimizer state
    and batch), ``output_bytes`` (what the step returns beyond its
    arguments: the train step updates the state in place, so its metrics;
    prefill's next tokens) and ``temp_bytes`` (the peak of live tensor
    bytes during the step, above the arguments).  Whether a cell fits a
    card is read off them against the card's memory; nothing here assumes
    a size;
  * ``cost``: FLOPs, bytes accessed and transcendentals, each kernel by its
    formula;
  * ``collectives`` (count and bytes by kind) and ``loop_aware``
    (``repro.launch.hlo_analysis``'s keys: every layer runs, so the totals
    count every layer), with the collectives by the logical collective that
    issued them and the kernels' calls and work;
  * ``trace_s`` (build and step) and ``num_devices``;
  * for an MoE config under ``moe-ep``, ``ep_tokens_per_rank``: of the t
    tokens a data shard routes, each rank of the model axis dispatches
    t // tp, as ``repro``'s ``ep`` body does, so the trailing t % tp get no
    routed expert (every token of a decode cell whose shard holds fewer
    lanes than tp).

The cell rules follow ``repro``'s ``build_cell`` line for line: a batch the
data axes do not divide is replicated, steps of models above 1e11
parameters take ``adamw_lowmem``, and the variants set ``moe_impl`` and
``ar_impl``.  Train is forward, loss, backward and the optimizer step with
remat; prefill is ``forward(remat=False)`` and the masked argmax of the
last position's logits; decode is one ``decode_step`` against a cache of
the shape's length, each rank holding its shard of it (its lanes and KV
heads, and for ``long_500k``, whose one lane the data axes do not divide,
its part of the sequence over ``data``; under ``kvdedup`` its part over
``model``).  A cell that raises is recorded with its error and traceback
and the sweep goes on.

Records go to results/dryrun_torch/<mesh>/<arch>--<shape>.json (cached;
``--force`` reruns).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--force] [--list]
      [--variant baseline|moe-ep|kvdedup|ring]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def storages(ts) -> dict:
    """The distinct storages of the tensors ``ts`` by identity, with their
    bytes."""
    out = {}
    for t in ts:
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def tensors(tree) -> list:
    """The tensors of a nest of dicts, lists and tuples; a module gives its
    parameters."""
    import torch
    from torch.utils import _pytree as pytree

    out = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            out.extend(leaf.parameters())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def measure(fn, arguments):
    """Run ``fn()`` under an :class:`~repro_torch.launch.op_analysis.OpAnalysis`
    that takes ``arguments`` (a nest of tensors and modules) as the step's
    inputs.  Returns ``fn``'s result and the record: ``memory``, ``cost``,
    ``collectives``, ``loop_aware``, ``collectives_issued_by``, ``kernels``.
    On ``meta`` tensors this is the dry run; on real ones it counts what the
    step did."""
    from repro_torch.launch.op_analysis import OpAnalysis

    arguments = tensors(arguments)
    known = storages(arguments)
    with OpAnalysis(arguments) as an:
        out = fn()
    outs = storages(tensors(out))
    return out, {
        "memory": {"argument_bytes": sum(known.values()),
                   "output_bytes": sum(n for k, n in outs.items() if k not in known),
                   "temp_bytes": an.peak_bytes},
        "cost": an.cost(),
        "collectives": {k: {"count": v["count"], "bytes": v["bytes"]}
                        for k, v in sorted(an.collectives.items())},
        "loop_aware": an.total_stats(),
        "collectives_issued_by": an.issued_stats(),
        "kernels": an.kernels,
    }


def build_cell(arch: str, shape_name: str, multi_pod: bool, variant: str = "baseline"):
    """Construct ``(mesh, rules, fn, arguments)`` for a cell, inside the
    current (fake) world: ``fn()`` runs rank 0's step on its ``meta``
    shards, ``arguments`` are the tensors it takes (parameters, optimizer
    state, batch; a decode step's cache too).

    Variants (``repro``'s):
      baseline  -- current defaults (grouped-GQA, SP, flash)
      moe-ep    -- MoE layers hold their experts over the model axis and
                   exchange tokens with the binary-exchange all-to-all
      kvdedup   -- decode only: KV heads kept at their true count
                   (replicated) and the KV cache sharded over the model
                   axis on the sequence dim (kills GQA padding waste)
      ring      -- MoE all-reduce via the explicit neighbour ring
    """
    from repro_torch.configs import SHAPES, get_arch, input_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel.mesh import axis_size
    from repro_torch.parallel.sharding import mesh_axes, parallel_rules
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.optimizer import OptConfig

    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = mesh_axes(multi_pod=multi_pod)
    tp = axis_size(mesh, "model")

    # batch too small for the data axes (long_500k has batch=1): replicate
    # the batch and shard the KV cache sequence dim over "data" instead
    batch_ax = rules.get("batch")
    names = batch_ax if isinstance(batch_ax, tuple) else (batch_ax,)
    bdiv = math.prod(axis_size(mesh, nm) for nm in names if nm)
    seq_sharded = False
    if shape.global_batch % bdiv:
        rules = dict(rules)
        rules["batch"] = None
        seq_sharded = True
        bdiv = 1

    opt_name = "adamw_lowmem" if cfg.param_count() > 1.0e11 else "adamw"
    moe_impl = "ep" if variant == "moe-ep" else "tp"
    ar_impl = "ring" if variant == "ring" else "psum"
    train_cfg = TrainConfig(opt=OptConfig(name=opt_name), moe_impl=moe_impl,
                            ar_impl=ar_impl)
    kv_pad = True
    if variant == "kvdedup":
        kv_pad = False
        rules = dict(rules)
        rules["kv_heads"] = None
        rules["seq_shard"] = "model"
        seq_sharded = True

    with parallel_rules(rules, mesh):
        batch = input_specs(cfg, shape, device="meta",
                            batch=shape.global_batch // bdiv)
        if shape.kind == "train":
            fn, args = train_step(cfg, mesh, batch, train_cfg)
        elif shape.kind == "prefill":
            model = sharded_model(cfg, mesh, moe_impl, kv_pad=kv_pad)

            def fn():
                return prefill(model, batch, {"moe_impl": moe_impl, "ar_impl": ar_impl})

            args = (model, batch)
        else:  # decode
            model = sharded_model(cfg, mesh, moe_impl, kv_pad=kv_pad)
            cache = T.init_cache(model, shape.global_batch // bdiv, shape.seq_len,
                                 seq_sharded=seq_sharded)

            def fn():
                return T.decode_step(model, cache, batch["tokens"], batch["position"],
                                     moe_ctx={"moe_impl": moe_impl, "ar_impl": ar_impl},
                                     seq_sharded=seq_sharded)

            args = (model, cache, batch)
    # the tokens a data shard routes (the MoE takes the whole sequence), of
    # which each ep rank dispatches its t // tp
    moe_tokens = shape.global_batch // bdiv * (1 if shape.kind == "decode" else shape.seq_len)
    info = {"opt": opt_name if shape.kind == "train" else None, "moe_impl": moe_impl,
            "ar_impl": ar_impl, "seq_sharded": seq_sharded, "kv_pad": kv_pad, "tp": tp,
            "batch_per_rank": shape.global_batch // bdiv,
            "ep_tokens_per_rank": (moe_tokens // tp if cfg.n_experts and moe_impl == "ep"
                                   else None)}
    return mesh, rules, fn, args, info


def sharded_model(cfg, mesh, moe_impl: str = "tp", *, device="meta", seed: int = 0,
                  kv_pad: bool = True):
    """This rank's bfloat16 shards of ``cfg``'s model under the installed
    rules, its heads padded for the mesh's model axis (its KV heads only
    with ``kv_pad``): on ``meta`` shapes only, else weights drawn from
    ``seed`` on ``device`` (the same draw on every rank) and then cut."""
    import torch

    from repro_torch.convert import shard_params
    from repro_torch.models import transformer as T
    from repro_torch.parallel.mesh import axis_size

    tp = axis_size(mesh, "model") if mesh is not None else 1
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    full = T.init_params(cfg, gen, tp=tp, device=device, dtype=torch.bfloat16,
                         kv_pad=kv_pad)
    return full if mesh is None else shard_params(full, mesh, moe_impl)


def train_step(cfg, mesh, batch, train_cfg=None, **model_kw):
    """``(fn, arguments)`` of one train step of ``cfg`` on this rank's
    shards (:func:`sharded_model`, ``model_kw``) and ``batch``: forward,
    loss, backward and the optimizer step, with remat.  ``fn()`` returns
    the step's metrics; ``arguments`` are the state and the batch."""
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state

    train_cfg = TrainConfig() if train_cfg is None else train_cfg
    model = sharded_model(cfg, mesh, train_cfg.moe_impl, **model_kw)
    state = {"params": model, "opt": init_opt_state(model, train_cfg.opt)}
    step = make_train_step(cfg, train_cfg)

    def fn():
        return step(state, batch)[1]

    return fn, (state, batch)


def prefill(model, batch, moe_ctx=None):
    """``forward(remat=False)`` without gradients (the MoE layers as
    ``moe_ctx`` says), then the argmax of the last position's logits over
    the real vocabulary.  Under a mesh the last
    row comes from the sequence axis's last rank (each rank's last row is
    gathered), each model rank scores its vocabulary slice, and the best
    score and then the least id that reaches it are reduced over the axis
    (``jnp.argmax`` takes the first maximum: ``transformer.greedy_tokens``,
    which ``decode_step`` shares)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.parallel.collectives import gather_from

    with torch.no_grad():
        h = T.forward(model, batch, moe_ctx=moe_ctx, remat=False)
        sp = T.seq_sp_axis()
        last = h[:, -1:] if sp is None else gather_from(h[:, -1:].contiguous(), sp, 1)
        return T.greedy_tokens(model, last[:, -1])


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             variant: str = "baseline"):
    """Trace one cell in a fake world of its mesh's size and record it
    (module docstring); a cached ``ok`` record is returned unless
    ``force``."""
    from repro_torch.parallel.mesh import fake_world
    from repro_torch.parallel.sharding import parallel_rules

    mesh_name = "multi" if multi_pod else "single"
    out_dir = RESULTS / mesh_name if variant == "baseline" else \
        RESULTS.parent / f"dryrun_torch_{variant}" / mesh_name
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file = out_dir / f"{arch}--{shape_name}.json"
    if out_file.exists() and not force:
        rec = json.loads(out_file.read_text())
        if rec.get("status") == "ok":
            print(f"[cached] {mesh_name} {arch} {shape_name}")
            return rec

    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "error"}
    try:
        with fake_world(512 if multi_pod else 256):
            mesh, rules, fn, args, info = build_cell(arch, shape_name, multi_pod, variant)
            with parallel_rules(rules, mesh):
                _, measured = measure(fn, args)
            rec.update({"status": "ok", "trace_s": round(time.time() - t0, 1), **measured,
                        "num_devices": mesh.mesh.numel(), **info})
        print(f"[ok] {mesh_name} {arch} {shape_name}: trace={rec['trace_s']:.1f}s "
              f"flops={rec['cost']['flops']:.3e} args={rec['memory']['argument_bytes']} "
              f"temp={rec['memory']['temp_bytes']}")
    except Exception as e:  # noqa: BLE001 - record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {mesh_name} {arch} {shape_name}: {rec['error'][:200]}")
    out_file.write_text(json.dumps(rec, indent=2))
    return rec


def cells(arch_filter=None, shape_filter=None):
    from repro_torch.configs import ARCHS, applicable_shapes, get_arch

    for name in ARCHS:
        if name == "gpt-moe-1.1t":
            continue  # paper-internal model: MFU-sim only, not a dry-run cell
        if arch_filter and arch_filter not in (name,):
            continue
        cfg = get_arch(name)
        for s in applicable_shapes(cfg):
            if shape_filter and s.name != shape_filter:
                continue
            yield name, s.name


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "moe-ep", "kvdedup", "ring"])
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    from repro_torch.configs import ALIASES

    arch = ALIASES.get(args.arch, args.arch) if args.arch else None

    todo = list(cells(arch, args.shape))
    if args.list:
        for a, s in todo:
            print(a, s)
        return
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    for multi in meshes:
        for a, s in todo:
            rec = run_cell(a, s, multi, args.force, args.variant)
            if rec["status"] == "ok":
                n_ok += 1
            else:
                n_fail += 1
    print(f"done: {n_ok} ok, {n_fail} failed")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
