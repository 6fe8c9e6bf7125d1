"""The port's parallel slice against the JAX package, on the CPU.

``repro_torch.parallel`` runs one process per rank over ``torch.distributed``
(gloo); ``repro.parallel`` runs one program over a mesh of JAX devices.
This file holds the two to each other in two worlds, each started as

    python tests/test_torch_parallel.py world8   # or world4

which computes the JAX references first (``shard_map`` over 8 forced host
devices, as ``tests/_sharded_checks.py`` does, or the unsharded JAX
model), then spawns the gloo ranks, which compare their shards with them
and report errors.  The script prints one JSON line of results; the tests
below read it (one run per world and pytest worker).

* world8 (8 ranks): every collective on float32 and int32 inputs, on a
  shape no axis divides (the ring's padded path) too; float32 rings
  bit-equal to JAX's ring, integers exact; the binary exchange against
  ``all_to_all_baseline`` and JAX's; each collective's gradient against the
  unsharded function's; ``gpipe`` over 4 stages against JAX's and against
  the stages in sequence; ``repro``'s ``moe_apply_local`` run directly in
  ``shard_map`` with ``_moe_dispatch``'s specs (mesh (2, 4), reduced
  Mixtral at ``capacity_factor=16.0``, so no assignment drops and the two
  modes route alike) against the port's ``tp`` and ``ep`` modes, values
  and every gradient.
* world4 (4 ranks): reduced Mixtral and StarCoder2 sharded at meshes (1, 4)
  and (2, 2) against the unsharded JAX forward, loss and every gradient,
  and three AdamW steps; Mixtral at its own capacity factor at (1, 4),
  where the routing is the unsharded one, and at 16.0 at (2, 2), where
  capacity is per data shard; the vocab-parallel embedding and loss
  against the off-mesh ones with padded vocabulary ids; the orchestrated
  mesh's axes.

Every draw comes from numpy with a fixed seed.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, shard_params
from repro_torch.models import forward, lm_loss
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import embed_tokens
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import Axis, make_mesh, mesh_axis, spawn_world
from repro_torch.parallel.pipeline import gpipe
from repro_torch.parallel.specs import (cache_pspecs, opt_pspecs, param_pspecs,
                                        shard_tensor)
from repro_torch.train import OptConfig, TrainConfig, init_opt_state, make_train_step
from repro_torch.train import synthetic_batch

ROOT = Path(__file__).resolve().parents[1]

# float32 on both sides: a model shard's sums run in another order than the
# unsharded model's (and the all-reduces add the shards), so activations and
# the loss agree to ~1e-6 relative and gradients to ~1e-5 of their largest
# entry; 1e-4 holds either.  Three Adam steps move each weight by ~lr
# whatever its gradient's size (tests/test_torch_windowed.py).
TOL = 1e-4
PARAM_TOL = 1e-4
ADAM_EPS = 1e-6
# psum and gloo's all-reduce add 8 float32 terms in other orders
PSUM_TOL = 1e-5
GPIPE_TOL = 1e-5                  # check_gpipe's tolerance
MOE_CF = 16.0                     # tests/_sharded_checks.py: no assignment drops


# ------------------------------------------------------------------ shared


def _err(got, want) -> float:
    """Max abs error over the reference's largest entry (1e-3 at least)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max() / max(1e-3, np.abs(want).max())) if want.size else 0.0


def _exact(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and got.dtype == want.dtype and \
        got.tobytes() == want.tobytes()


def _perturb(tree, seed):
    """Biases and norm scales replaced by seeded values, so that every
    parameter matters (tests/test_torch_windowed.py)."""
    rng = np.random.default_rng(seed)

    def walk(x, name=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, name) for v in x]
        a = np.array(x, copy=True)
        if name in ("bq", "bk", "bv", "bias", "scale"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(tree)


# ------------------------------------------------------------------ world8: collectives


COLL_SHAPES = {"even": (16, 3), "padded": (5, 3), "cols": (3, 16)}


def _coll_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in COLL_SHAPES.items():
        out[f"{name}_f32"] = rng.standard_normal((8,) + shape).astype(np.float32)
        out[f"{name}_i32"] = rng.integers(-1000, 1000, (8,) + shape).astype(np.int32)
    out["gather_f32"] = rng.standard_normal((8, 2, 3)).astype(np.float32)
    out["gather_i32"] = rng.integers(-1000, 1000, (8, 2, 3)).astype(np.int32)
    out["a2a_f32"] = rng.standard_normal((8, 8, 4, 2)).astype(np.float32)
    out["a2a_i32"] = rng.integers(-1000, 1000, (8, 8, 4, 2)).astype(np.int32)
    # gradient weights: one per rank for the per-rank terms, one shared
    out["w_even"] = rng.standard_normal((8,) + COLL_SHAPES["even"]).astype(np.float32)
    out["w_rs"] = rng.standard_normal((8, 2, 3)).astype(np.float32)
    out["w_ag"] = rng.standard_normal((8, 16, 3)).astype(np.float32)
    out["w_a2a"] = rng.standard_normal((8, 8, 4, 2)).astype(np.float32)
    out["a_copy"] = rng.standard_normal((8, 16, 3)).astype(np.float32)
    # gpipe: check_gpipe's sizes, 4 stages of tanh(x @ w)
    out["gp_w"] = (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32)
    out["gp_x"] = rng.standard_normal((6, 2, 8)).astype(np.float32)
    return out


def _jax_collectives(inp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.parallel import collectives as JC
    from repro.parallel.compat import shard_map
    from repro.parallel.pipeline import gpipe as jax_gpipe

    mesh = jax.make_mesh((8,), ("model",))
    # every collective of one dtype in one shard_map: (name, input, fn)
    cases = []
    for name in COLL_SHAPES:
        cases += [(f"ring_{name}", name, lambda v: JC.ring_all_reduce(v, "model", impl="ring")),
                  (f"psum_{name}", name, lambda v: JC.ring_all_reduce(v, "model", impl="psum"))]
    cases += [("rs", "even", lambda v: JC.ring_reduce_scatter(v, "model", 0)),
              ("rs1", "cols", lambda v: JC.ring_reduce_scatter(v, "model", 1)),
              ("ag", "gather", lambda v: JC.ring_all_gather(v, "model", 0)),
              ("ag1", "gather", lambda v: JC.ring_all_gather(v, "model", 1)),
              ("binary", "a2a", lambda v: JC.binary_exchange_all_to_all(v, "model")),
              ("xla", "a2a", lambda v: JC.all_to_all_baseline(v, "model"))]

    def body(*xs):
        return tuple(fn(x[0])[None] for (_, _, fn), x in zip(cases, xs))

    run = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("model"),) * len(cases),
                            out_specs=(P("model"),) * len(cases)))
    ref = {}
    for dt in ("f32", "i32"):
        outs = run(*(jnp.asarray(inp[f"{src}_{dt}"]) for _, src, _ in cases))
        for (key, _, _), o in zip(cases, outs):
            ref[f"{key}_{dt}"] = np.asarray(o)

    pmesh = jax.make_mesh((4,), ("pod",))
    ws = jnp.asarray(inp["gp_w"])
    out = jax.jit(shard_map(
        lambda xr: jax_gpipe(lambda s, v: jnp.tanh(v @ ws[s]), xr, axis="pod", n_micro=6),
        mesh=pmesh, in_specs=P(), out_specs=P(), check_vma=False))(jnp.asarray(inp["gp_x"]))
    ref["gpipe"] = np.asarray(out)
    return ref


def _ring_order_sum(x: np.ndarray, i: int, n: int, axis: int) -> np.ndarray:
    """Chunk i of the sum over ranks in the ring's order of adds: rank i's
    chunk arrives after n-1 hops that added chunks i-1, i-2, ... in turn."""
    chunks = [np.split(x[r], n, axis=axis)[i] for r in range(n)]
    acc = np.zeros_like(chunks[0])
    for k in range(n - 1):
        src = (i - (n - 1) + k) % n
        acc = chunks[src] + acc
    return acc + chunks[i]


def _check_collectives(rank, inp, ref, out):
    mesh = make_mesh((8,), ("model",), device="cpu")
    ax = mesh_axis(mesh, "model")
    i = ax.index
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    for dt in ("f32", "i32"):
        for name in COLL_SHAPES:
            x = t(inp[f"{name}_{dt}"][i])
            ring = C.ring_all_reduce(x, ax, impl="ring").numpy()
            out[f"ring_{name}_{dt}_equal_jax"] = _exact(ring, ref[f"ring_{name}_{dt}"][i])
            ps = C.ring_all_reduce(x, ax, impl="psum").numpy()
            out[f"psum_{name}_{dt}_err"] = (
                0.0 if _exact(ps, ref[f"psum_{name}_{dt}"][i]) else
                _err(ps, ref[f"psum_{name}_{dt}"][i]) if dt == "f32" else float("inf"))
        x = t(inp[f"even_{dt}"][i])
        rs = C.ring_reduce_scatter(x, ax, 0).numpy()
        out[f"rs_{dt}_equal_jax"] = _exact(rs, ref[f"rs_{dt}"][i])
        out[f"rs_{dt}_ring_order"] = _exact(rs, _ring_order_sum(inp[f"even_{dt}"], i, 8, 0))
        rs1 = C.ring_reduce_scatter(t(inp[f"cols_{dt}"][i]), ax, 1).numpy()
        out[f"rs1_{dt}_equal_jax"] = _exact(rs1, ref[f"rs1_{dt}"][i])
        g = t(inp[f"gather_{dt}"][i])
        out[f"ag_{dt}_equal_jax"] = _exact(C.ring_all_gather(g, ax, 0).numpy(), ref[f"ag_{dt}"][i])
        out[f"ag1_{dt}_equal_jax"] = _exact(C.ring_all_gather(g, ax, 1).numpy(),
                                            ref[f"ag1_{dt}"][i])
        a = t(inp[f"a2a_{dt}"][i])
        be = C.binary_exchange_all_to_all(a, ax).numpy()
        bl = C.all_to_all_baseline(a, ax).numpy()
        out[f"binary_{dt}_equal_jax"] = _exact(be, ref[f"binary_{dt}"][i])
        out[f"xla_{dt}_equal_jax"] = _exact(bl, ref[f"xla_{dt}"][i])
        out[f"binary_{dt}_equal_baseline"] = _exact(be, bl)
        out[f"a2a_{dt}_is_transpose"] = _exact(be, inp[f"a2a_{dt}"][:, i])

    # gradients against the unsharded function, computed on every rank
    def grad_of(fn, x):
        x = x.clone().requires_grad_(True)
        fn(x).backward()
        return x.grad.numpy()

    def unsharded(fn, xs):
        xs = xs.clone().requires_grad_(True)
        fn(xs).backward()
        return xs.grad.numpy()

    xs = t(inp["even_f32"])
    w = t(inp["w_even"][0])                           # a replicated consumer
    for impl in ("ring", "psum"):
        got = grad_of(lambda v: (w * C.ring_all_reduce(v, ax, impl=impl)).sum(), xs[i])
        want = unsharded(lambda v: (w * v.sum(0)).sum(), xs)[i]
        out[f"grad_all_reduce_{impl}_err"] = _err(got, want)
    xp = t(inp["padded_f32"])
    got = grad_of(lambda v: (v.new_ones(v.shape) * C.ring_all_reduce(v, ax)).sum(), xp[i])
    out["grad_all_reduce_padded_err"] = _err(got, np.ones(xp.shape[1:], np.float32))
    wr = t(inp["w_rs"])                               # a term per rank
    got = grad_of(lambda v: (wr[i] * C.ring_reduce_scatter(v, ax, 0)).sum(), xs[i])
    want = unsharded(lambda v: sum((wr[r] * v.sum(0).split(2, 0)[r]).sum() for r in range(8)),
                     xs)[i]
    out["grad_reduce_scatter_err"] = _err(got, want)
    xg = t(inp["gather_f32"])
    wa = t(inp["w_ag"])
    got = grad_of(lambda v: (wa[i] * C.ring_all_gather(v, ax, 0)).sum(), xg[i])
    want = unsharded(lambda v: sum((wa[r] * v.reshape(16, 3)).sum() for r in range(8)), xg)[i]
    out["grad_all_gather_err"] = _err(got, want)
    xa = t(inp["a2a_f32"])
    wt = t(inp["w_a2a"])
    for name, fn in (("binary", C.binary_exchange_all_to_all), ("xla", C.all_to_all_baseline)):
        got = grad_of(lambda v: (wt[i] * fn(v, ax)).sum(), xa[i])
        want = unsharded(lambda v: sum((wt[r] * v[:, r]).sum() for r in range(8)), xa)[i]
        out[f"grad_{name}_err"] = _err(got, want)
    # the replicated region's pair: split_to keeps this rank's chunk of a
    # replicated value (a term per rank), gather_from assembles the chunks
    # for a consumer every rank computes whole
    got = grad_of(lambda v: (wr[i] * C.split_to(v, ax, 0)).sum(), xs[0])
    out["split_to_value"] = _exact(C.split_to(xs[0], ax, 0).numpy(),
                                   inp["even_f32"][0].reshape(8, 2, 3)[i])
    want = unsharded(lambda v: sum((wr[r] * v[0].split(2, 0)[r]).sum() for r in range(8)), xs)[0]
    out["grad_split_to_err"] = _err(got, want)
    got = grad_of(lambda v: (wa[0] * C.gather_from(v, ax, 0)).sum(), xg[i])
    out["gather_from_value"] = _exact(C.gather_from(xg[i], ax, 0).numpy(),
                                      inp["gather_f32"].reshape(16, 3))
    want = unsharded(lambda v: (wa[0] * v.reshape(16, 3)).sum(), xg)[i]
    out["grad_gather_from_err"] = _err(got, want)
    ac = t(inp["a_copy"])                             # f: partial uses, summed by g
    got = grad_of(lambda v: (w * C.psum(C.copy_to(v, ax) * ac[i], ax)).sum(), xs[0])
    want = unsharded(lambda v: (w * (v[0] * ac).sum(0)).sum(), xs)[0]
    out["grad_copy_to_err"] = _err(got, want)
    perm = [(r, (r + 3) % 8) for r in range(8)]
    got = grad_of(lambda v: (wr[i] * C.ppermute(v, ax, perm)).sum(), t(inp["w_rs"][i]) * 2)
    out["grad_ppermute_err"] = _err(got, inp["w_rs"][(i + 3) % 8])
    mx = C.pmax(t(inp["even_f32"][i]), ax).numpy()
    out["pmax_equal"] = _exact(mx, inp["even_f32"].max(0))

    # gpipe over the 4 "pod" ranks of each row of a (2, 4) mesh
    pmesh = make_mesh((2, 4), ("data", "pod"), device="cpu")
    pax = mesh_axis(pmesh, "pod")
    ws = t(inp["gp_w"])
    xmb = t(inp["gp_x"]) if pax.index == 0 else torch.zeros(6, 2, 8)
    got = gpipe(lambda s, v: torch.tanh(v @ ws[s]), xmb, group=pax, n_micro=6).numpy()
    seq = inp["gp_x"]
    for s in range(4):
        seq = np.tanh(seq @ inp["gp_w"][s])
    out["gpipe_vs_jax"] = float(np.abs(got - ref["gpipe"]).max())
    out["gpipe_vs_sequence"] = float(np.abs(got - seq).max())


# ------------------------------------------------------------------ world8: MoE


def _moe_inputs():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.models import moe as JM

    cfg = dataclasses.replace(jax_get_arch("mixtral").reduced(), capacity_factor=MOE_CF)
    p = JM.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    rng = np.random.default_rng(4)
    return cfg, {k: np.asarray(v) for k, v in p.items()}, {
        "x": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32),
        "w": rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)}


MOE_MODES = [("tp", "binary", "psum"), ("tp", "binary", "ring"),
             ("ep", "binary", "psum"), ("ep", "xla", "psum")]


def _jax_moe(cfg, p, inp):
    """``repro``'s MoE body in ``shard_map`` over mesh (2, 4) with
    ``_moe_dispatch``'s specs, each mode; and the unsharded reference and
    its gradients (each data shard dispatched alone, as capacity is per
    shard)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.models import moe as JM
    from repro.parallel.compat import shard_map

    mesh = jax.make_mesh((2, 4), ("data", "model"))
    jp = jax.tree.map(jnp.asarray, p)
    x = jnp.asarray(inp["x"])
    ref = {}
    for impl, a2a, ar in MOE_MODES:
        if impl == "tp":
            wspec = {"router": P(None, None), "w_up": P(None, None, "model"),
                     "w_down": P(None, "model", None), "w_gate": P(None, None, "model")}
        else:
            wspec = {"router": P(None, None), "w_up": P("model", None, None),
                     "w_down": P("model", None, None), "w_gate": P("model", None, None)}
        body = functools.partial(JM.moe_apply_local, cfg=cfg, axis_name="model",
                                 moe_impl=impl, a2a_impl=a2a, ar_impl=ar, tp=4)
        try:
            y = jax.jit(shard_map(lambda pl, xl: body(pl, x=xl), mesh=mesh,
                                  in_specs=(wspec, P("data", None, None)),
                                  out_specs=P("data", None, None), check_vma=False))(jp, x)
            ref[f"shard_map_{impl}_{a2a}_{ar}"] = np.asarray(y)
        except Exception as e:     # recorded: the check then reads the unsharded body
            ref[f"shard_map_{impl}_{a2a}_{ar}_error"] = f"{type(e).__name__}: {e}"[:300]

    w = jnp.asarray(inp["w"])

    def loss(pp, xx):
        ys = [JM.moe_apply_local(pp, cfg, xx[2 * s:2 * s + 2], tp=1) for s in range(2)]
        return jnp.sum(w * jnp.concatenate(ys))

    ys = [JM.moe_apply_local(jp, cfg, x[2 * s:2 * s + 2], tp=1) for s in range(2)]
    ref["unsharded"] = np.asarray(jnp.concatenate(ys))
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, x)
    ref["grad_params"] = {k: np.asarray(v) for k, v in gp.items()}
    ref["grad_x"] = np.asarray(gx)
    return ref


class _MoEHolder(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        self.moe = MOE.MoE(**{k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _check_moe(rank, cfg_j, p, inp, ref, out):
    cfg = dataclasses.replace(get_arch("mixtral").reduced(), capacity_factor=MOE_CF)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    ax = mesh_axis(mesh, "model")
    dax = mesh_axis(mesh, "data")
    rows = slice(2 * dax.index, 2 * dax.index + 2)
    full = _MoEHolder(p)
    ys = {}
    with sharding.parallel_rules(sharding.mesh_axes(), mesh):
        for impl, a2a, ar in MOE_MODES:
            local = shard_params(full, mesh, moe_impl=impl)
            x = torch.from_numpy(inp["x"][rows].copy()).requires_grad_(True)
            y = MOE.moe_apply_local(local.moe, cfg, x, moe_impl=impl, a2a_impl=a2a,
                                    ar_impl=ar, tp=4, group=ax)
            key = f"{impl}_{a2a}_{ar}"
            ys[key] = y.detach().numpy()
            jax_key = f"shard_map_{key}"
            want = ref[jax_key][rows] if jax_key in ref else ref["unsharded"][rows]
            out[f"moe_{key}_vs_jax_err"] = _err(ys[key], want)
            out[f"moe_{key}_vs_unsharded_err"] = _err(ys[key], ref["unsharded"][rows])
            (torch.from_numpy(inp["w"][rows].copy()) * y).sum().backward()
            # the gradient of the whole loss: each data shard's term summed
            gx = x.grad.numpy()
            out[f"moe_{key}_grad_x_err"] = _err(gx, ref["grad_x"][rows])
            specs = param_pspecs(full, impl)
            worst = 0.0
            for name, prm in local.named_parameters():
                g = prm.grad.clone()
                torch.distributed.all_reduce(g, group=dax.group)
                want = shard_tensor(torch.from_numpy(ref["grad_params"][name.split(".")[-1]]),
                                    specs[name], mesh)
                worst = max(worst, _err(g.numpy(), want.numpy()))
            out[f"moe_{key}_grad_params_err"] = worst
    out["moe_ep_vs_tp_err"] = max(_err(ys[k], ys["tp_binary_psum"]) for k in ys)


def _world8(rank, inp, ref, moe_args):
    torch.set_num_threads(1)
    out = {}
    _check_collectives(rank, inp, ref, out)
    _check_moe(rank, *moe_args, out)
    return out


# ------------------------------------------------------------------ world4: models


SEQ = 32
LLAMA4_EP_CF = 4.0                # E / top_k of reduced Llama-4: no drops in either mode
# (arch, capacity factor, mesh, rules, sequence length); the rules are the
# default ones (sequence parallelism over "model"), "nosp" with seq_sp
# unmapped (the residual stream replicated over "model") or "fsdp" with
# fsdp mapped to "data" (and sequence parallelism)
MODEL_RUNS = [("mixtral", None, (1, 4), "sp", SEQ), ("mixtral", MOE_CF, (2, 2), "sp", SEQ),
              ("starcoder2", None, (1, 4), "sp", SEQ), ("starcoder2", None, (2, 2), "sp", SEQ),
              ("starcoder2", None, (1, 4), "nosp", SEQ),
              ("mixtral", MOE_CF, (2, 2), "fsdp", SEQ),
              ("starcoder2", None, (2, 2), "fsdp", SEQ),
              ("mixtral", None, (1, 4), "sp", 31),
              ("llama4", LLAMA4_EP_CF, (1, 4), "ep", SEQ),
              ("llama4", LLAMA4_EP_CF, (2, 2), "ep", SEQ)]
# "ep": the default rules with the MoE layers in ep mode (experts over the
# model axis, Llama-4's shared expert over ff)
RULES = {"sp": {}, "nosp": {"seq_sp": None}, "fsdp": {"fsdp": "data"}, "ep": {}}


def _run_tag(arch, shape, rules, seq):
    return (f"{arch}_{shape[0]}x{shape[1]}" + ("" if rules == "sp" else f"_{rules}")
            + ("" if seq == SEQ else f"_s{seq}"))


RUN_TAGS = [_run_tag(a, s, r, n) for a, _, s, r, n in MODEL_RUNS]


def _jax_model(arch, cf, seq):
    """The unsharded JAX references of one reduced config, tp-padded for 4
    ranks: hidden states, loss, every gradient, three AdamW steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.models import forward as jf
    from repro.models import init_params as jinit
    from repro.models import lm_loss as jl
    from repro.train.loop import TrainConfig as JTC
    from repro.train.loop import make_train_step as jstep
    from repro.train.optimizer import OptConfig as JOC
    from repro.train.optimizer import init_opt_state as jopt

    cfg = jax_get_arch(arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    tree = _perturb(jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(0), tp=4,
                                                   dtype=jnp.float32)), seed=11)
    tcfg = get_arch(arch).reduced()
    if cf is not None:
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    batches = [synthetic_batch(tcfg, i, 4, seq) for i in range(3)]
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(p):
        h = jf(p, cfg, jb, remat=False)
        return jl(p, cfg, h, jb["labels"]), h

    (loss, h), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    opt = JOC(lr=3e-3, warmup_steps=2, eps=ADAM_EPS)
    state = {"params": params, "opt": jopt(params, opt)}
    step = jax.jit(jstep(cfg, JTC(opt=opt, remat=False)))
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"tree": tree, "batches": batches, "h": np.asarray(h), "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads), "losses": losses, "norms": norms,
            "final": jax.tree.map(np.asarray, state["params"])}


def _named(tcfg, tree):
    return {n: p.detach() for n, p in
            params_from_jax(tcfg, tree, device="cpu").named_parameters()}


def _split_over(spec):
    return {a for ax in spec if ax is not None for a in (ax if isinstance(ax, tuple) else (ax,))}


def _check_model(arch, cf, shape, rules, seq, ref, out):
    import repro_torch.models.transformer as TM

    tcfg = get_arch(arch).reduced()
    if cf is not None:
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    tag = _run_tag(arch, shape, rules, seq)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    dax = mesh_axis(mesh, "data")
    per = 4 // shape[0]
    rows = slice(dax.index * per, (dax.index + 1) * per)
    full = params_from_jax(tcfg, ref["tree"], device="cpu")
    moe_impl = "ep" if rules == "ep" else "tp"
    with sharding.parallel_rules(sharding.mesh_axes(RULES[rules]), mesh):
        specs = param_pspecs(full, moe_impl)
        model = shard_params(full, mesh, moe_impl)
        b0 = {k: torch.from_numpy(v[rows].copy()) for k, v in ref["batches"][0].items()}
        h = forward(model, b0, moe_ctx={"moe_impl": moe_impl}, remat=False)
        out[f"{tag}_hidden_rows"] = h.shape[1]
        out[f"{tag}_hidden_err"] = _err(TM.full_sequence(h, seq).detach().numpy(),
                                        ref["h"][rows])
        loss = lm_loss(model, h, b0["labels"])
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        total = loss.detach().clone()
        if dax.size > 1:
            torch.distributed.all_reduce(total, group=dax.group)
        out[f"{tag}_loss_err"] = abs(float(total) / shape[0] - ref["loss"]) / abs(ref["loss"])
        want = _named(tcfg, ref["grads"])
        worst, worst_name, n_fsdp = 0.0, "", 0
        for name, g in zip(names, grads):
            g = g.clone()
            if "data" in _split_over(specs[name]):
                n_fsdp += 1             # the gather's backward summed it over data
            elif dax.size > 1:
                torch.distributed.all_reduce(g, group=dax.group)
            e = _err(g.numpy() / shape[0], shard_tensor(want[name], specs[name], mesh).numpy())
            if e > worst:
                worst, worst_name = e, name
        out[f"{tag}_grads_err"] = worst
        out[f"{tag}_grads_worst"] = worst_name
        out[f"{tag}_n_grads"] = len(grads)
        out[f"{tag}_n_fsdp"] = n_fsdp

        opt = OptConfig(lr=3e-3, warmup_steps=2, eps=ADAM_EPS)
        model = shard_params(full, mesh, moe_impl)
        state = {"params": model, "opt": init_opt_state(model, opt)}
        out[f"{tag}_opt_equals_specs"] = all(
            tuple(state["opt"][k][n].shape) == tuple(p.shape)
            for n, p in model.named_parameters() for k in ("master", "m", "v"))
        step = make_train_step(tcfg, TrainConfig(opt=opt, moe_impl=moe_impl))
        # the layer inputs that remat saves (the checkpoint's x), first step
        saved, real = [], TM.checkpoint
        TM.checkpoint = lambda fn, layer, cfg, x, *a, **k: (
            saved.append(x.shape[1]), real(fn, layer, cfg, x, *a, **k))[1]
        losses, norms = [], []
        try:
            for b in ref["batches"]:
                state, m = step(state, {k: torch.from_numpy(v[rows].copy())
                                        for k, v in b.items()})
                TM.checkpoint = real
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        finally:
            TM.checkpoint = real
        out[f"{tag}_saved_rows"] = sorted(set(saved))
        out[f"{tag}_n_saved"] = len(saved)
        out[f"{tag}_step_loss_err"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        out[f"{tag}_step_norm_err"] = max(abs(a - b) / abs(b) for a, b in zip(norms, ref["norms"]))
        final = _named(tcfg, ref["final"])
        out[f"{tag}_params_err"] = max(
            float(np.abs(p.detach().numpy() - shard_tensor(final[n], specs[n], mesh).numpy()).max())
            for n, p in model.named_parameters())


def _check_vocab(out):
    """The vocab-parallel embedding and loss against the off-mesh ones, at
    a vocabulary of 250 padded to 256 (the last shard holds 6 padded ids),
    with the residual stream replicated over the model axis and, under
    sequence parallelism, the loss given this rank's slice of the 24 rows
    (6 a rank)."""
    tcfg = dataclasses.replace(get_arch("starcoder2").reduced(), vocab_size=250)
    from repro_torch.models import init_params
    full = init_params(tcfg, torch.Generator().manual_seed(5), device="cpu",
                       dtype=torch.float32)
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, 256, (2, 24)))
    ids[0, :6] = torch.arange(250, 256)                      # padded ids
    labels = torch.from_numpy(rng.integers(0, 250, (2, 24)))
    x = torch.from_numpy(rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32))

    def run(model, xin):
        emb = embed_tokens(model, ids)
        xx = xin.clone().requires_grad_(True)
        loss = lm_loss(model, xx, labels)
        g_emb, g_x = torch.autograd.grad(loss + (emb * x).sum(), (model.embed, xx))
        return emb.detach(), loss.detach(), g_emb, g_x

    want = run(full, x)
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    rows = slice(6 * mesh_axis(mesh, "model").index, 6 * mesh_axis(mesh, "model").index + 6)
    for key, rules, xin, gx_want in (("vocab_nosp", {"seq_sp": None}, x, want[3]),
                                     ("vocab", {}, x[:, rows], want[3][:, rows])):
        with sharding.parallel_rules(sharding.mesh_axes(rules), mesh):
            spec = param_pspecs(full)["embed"]
            got = run(shard_params(full, mesh), xin)
            w_emb = shard_tensor(want[2], spec, mesh)
        out[f"{key}_embed_err"] = _err(got[0].numpy(), want[0].numpy())
        out[f"{key}_loss_err"] = abs(float(got[1]) - float(want[1])) / abs(float(want[1]))
        out[f"{key}_grad_embed_err"] = _err(got[2].numpy(), w_emb.numpy())
        out[f"{key}_grad_x_err"] = _err(got[3].numpy(), gx_want.numpy())
        out[f"{key}_spec"] = list(spec)


def _check_orchestrated(rank, out):
    from repro_torch.core.placement import make_orchestrated_mesh, plan_mesh

    plan = plan_mesh(8, 1, tp_size=2, dp_size=2)
    mesh = make_orchestrated_mesh(plan, device="cpu")
    ax = mesh_axis(mesh, "model")
    out["orch_grid"] = mesh.mesh.tolist()
    out["orch_plan_grid"] = plan.device_grid.tolist()
    row = [r for r in plan.device_grid.tolist() if rank in r][0]
    out["orch_axis_in_ring_order"] = list(ax.ranks) == row and row[ax.index] == rank
    # a ring over the orchestrated axis: the +1 neighbor is the next GPU of
    # the plan's ring, whatever the rank numbers
    got = C.ppermute(torch.tensor([float(rank)]), ax, [(0, 1), (1, 0)])
    out["orch_neighbor"] = int(got) == row[(ax.index + 1) % 2]
    x = torch.tensor([float(rank + 1)] * 4)
    out["orch_ring_equals_psum"] = _exact(C.ring_all_reduce(x, ax).numpy(),
                                          C.psum(x, ax).numpy())


def _world4(rank, refs):
    torch.set_num_threads(1)
    out = {}
    for arch, cf, shape, rules, seq in MODEL_RUNS:
        _check_model(arch, cf, shape, rules, seq, refs[(arch, cf, seq)], out)
    _check_vocab(out)
    _check_orchestrated(rank, out)
    return out


# ------------------------------------------------------------------ entry point


def _main(which):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    torch.set_num_threads(1)
    if which == "world8":
        inp = _coll_inputs()
        ref = _jax_collectives(inp)
        cfg, p, minp = _moe_inputs()
        mref = _jax_moe(cfg, p, minp)
        outs = spawn_world(_world8, 8, inp, ref, (None, p, minp, mref), backend="gloo",
                           timeout_s=300)
        errors = {k: v for k, v in mref.items() if k.endswith("_error")}
    else:
        refs = {key: _jax_model(*key)
                for key in dict.fromkeys((a, cf, n) for a, cf, _, _, n in MODEL_RUNS)}
        outs = spawn_world(_world4, 4, refs, backend="gloo", timeout_s=300)
        errors = {}
    # every rank's result; booleans must hold on all, errors take the worst
    merged = {}
    for key in outs[0]:
        vals = [o[key] for o in outs]
        if isinstance(vals[0], bool):
            merged[key] = all(vals)
        elif isinstance(vals[0], float):
            merged[key] = max(vals)
        else:
            merged[key] = vals
    merged["jax_errors"] = errors
    print(json.dumps(merged))


@functools.lru_cache(maxsize=None)
def _world(which: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, str(Path(__file__)), which], capture_output=True,
                         text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------ tests: world8


@pytest.mark.parametrize("dt", ["f32", "i32"])
@pytest.mark.parametrize("shape", sorted(COLL_SHAPES))
def test_ring_all_reduce_equals_jax_ring_and_psum(shape, dt):
    """Float32 rings bit-equal to JAX's, integers exact; the padded shape
    runs the flat path.  psum adds in gloo's order: exact for integers."""
    r = _world("world8")
    assert r[f"ring_{shape}_{dt}_equal_jax"]
    assert r[f"psum_{shape}_{dt}_err"] <= (PSUM_TOL if dt == "f32" else 0.0)


@pytest.mark.parametrize("dt", ["f32", "i32"])
def test_ring_phases_equal_jax(dt):
    r = _world("world8")
    for key in ("rs", "rs1", "ag", "ag1"):
        assert r[f"{key}_{dt}_equal_jax"], key
    assert r[f"rs_{dt}_ring_order"]          # the ring's order of adds, in numpy


@pytest.mark.parametrize("dt", ["f32", "i32"])
def test_binary_exchange_equals_baseline_and_jax(dt):
    r = _world("world8")
    assert r[f"binary_{dt}_equal_jax"] and r[f"xla_{dt}_equal_jax"]
    assert r[f"binary_{dt}_equal_baseline"] and r[f"a2a_{dt}_is_transpose"]


@pytest.mark.parametrize("name", ["all_reduce_ring", "all_reduce_psum", "all_reduce_padded",
                                  "reduce_scatter", "all_gather", "binary", "xla",
                                  "copy_to", "ppermute", "split_to", "gather_from"])
def test_collective_gradients_match_the_unsharded_function(name):
    assert _world("world8")[f"grad_{name}_err"] <= 1e-6
    if name in ("split_to", "gather_from"):
        assert _world("world8")[f"{name}_value"]


def test_pmax_and_gpipe():
    r = _world("world8")
    assert r["pmax_equal"]
    assert r["gpipe_vs_jax"] <= GPIPE_TOL and r["gpipe_vs_sequence"] <= GPIPE_TOL


@pytest.mark.parametrize("mode", ["_".join(m) for m in MOE_MODES])
def test_moe_modes_match_repro_shard_map_and_gradients(mode):
    """The port's tp and ep modes on mesh (2, 4) against repro's body in
    shard_map (which runs on this jax) and the unsharded MoE's gradients."""
    r = _world("world8")
    assert r["jax_errors"] == {}
    assert r[f"moe_{mode}_vs_jax_err"] <= TOL
    assert r[f"moe_{mode}_vs_unsharded_err"] <= TOL
    assert r[f"moe_{mode}_grad_x_err"] <= TOL
    assert r[f"moe_{mode}_grad_params_err"] <= TOL


def test_moe_ep_agrees_with_tp_without_drops():
    assert _world("world8")["moe_ep_vs_tp_err"] <= TOL


# ------------------------------------------------------------------ tests: world4

# parameters of the reduced configs, each with its gradient: Llama-4's 4
# layers hold two MoE layers with a shared expert
N_GRADS = {"mixtral": 23, "starcoder2": 29, "llama4": 47}


@pytest.mark.parametrize("run", RUN_TAGS)
def test_sharded_model_matches_unsharded_jax(run):
    r = _world("world4")
    assert r[f"{run}_hidden_err"] <= TOL
    assert r[f"{run}_loss_err"] <= TOL
    assert r[f"{run}_grads_err"] <= TOL, r[f"{run}_grads_worst"]
    arch = MODEL_RUNS[RUN_TAGS.index(run)][0]
    assert r[f"{run}_n_grads"][0] == N_GRADS[arch]


@pytest.mark.parametrize("run", RUN_TAGS)
def test_sharded_adamw_steps_match_jax(run):
    r = _world("world4")
    assert r[f"{run}_step_loss_err"] <= TOL
    assert r[f"{run}_step_norm_err"] <= TOL
    assert r[f"{run}_params_err"] <= PARAM_TOL
    assert r[f"{run}_opt_equals_specs"]


@pytest.mark.parametrize("run", RUN_TAGS)
def test_sequence_parallel_residual_holds_a_slice(run):
    """Under sequence parallelism the hidden states and every layer input
    that remat saves hold ceil(S / tp) rows of the sequence, with seq_sp
    unmapped all S; FSDP splits the weights that have an fsdp dimension."""
    r = _world("world4")
    arch, _, shape, rules, seq = MODEL_RUNS[RUN_TAGS.index(run)]
    rows = seq if rules == "nosp" else -(-seq // shape[1])
    assert r[f"{run}_hidden_rows"] == [rows] * 4
    assert all(s == [rows] for s in r[f"{run}_saved_rows"])
    assert r[f"{run}_n_saved"] == [get_arch(arch).reduced().num_layers] * 4
    assert all(n > 0 for n in r[f"{run}_n_fsdp"]) == (rules == "fsdp")


def _check_vocab_keys(key):
    r = _world("world4")
    assert r[f"{key}_spec"][0] == ["model", None]
    assert r[f"{key}_embed_err"] <= 1e-6 and r[f"{key}_loss_err"] <= 1e-6
    assert r[f"{key}_grad_embed_err"] <= 1e-6 and r[f"{key}_grad_x_err"] <= 1e-6


def test_vocab_parallel_embedding_and_loss_match_off_mesh():
    """Under the default rules: the loss takes this rank's sequence slice."""
    _check_vocab_keys("vocab")


def test_vocab_parallel_loss_without_sequence_parallelism():
    _check_vocab_keys("vocab_nosp")


def test_orchestrated_mesh_axes_follow_the_plan():
    r = _world("world4")
    assert r["orch_grid"][0] == r["orch_plan_grid"][0] == [[1, 0], [3, 2]]
    assert r["orch_axis_in_ring_order"] and r["orch_neighbor"] and r["orch_ring_equals_psum"]


# ------------------------------------------------------------------ tests: one process


def _jax_rules():
    from repro.parallel import sharding as js
    return js


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_equal_repro(multi_pod):
    js = _jax_rules()
    assert sharding.DEFAULT_RULES == js.DEFAULT_RULES
    assert sharding.mesh_axes(multi_pod=multi_pod) == js.mesh_axes(multi_pod=multi_pod)
    assert sharding.mesh_axes({"ff": None}) == js.mesh_axes({"ff": None})
    for v in ("pod", ("pod", "data"), ("pod",), ("a", "b", "pod"), None, "model"):
        assert sharding._drop_pod(v) == js._drop_pod(v)
    axes = sharding.logical("batch", None, "ff", "vocab", "experts")
    assert sharding.resolve(axes) is None
    with sharding.parallel_rules(sharding.mesh_axes(multi_pod=multi_pod)), \
            js.parallel_rules(js.mesh_axes(multi_pod=multi_pod)):
        assert sharding.resolve(axes) == tuple(js.resolve(axes))
        x = torch.zeros(3, 4)
        assert sharding.shard(x, ("batch", "ff")) is x
    assert sharding.get_rules() is None and sharding.get_mesh() is None


SPEC_ARCHS = ["mixtral", "starcoder2", "llama4", "mamba2", "recurrentgemma", "whisper",
              "paligemma"]


def _key(parts):
    """A leaf's rule key: its names without layer indices or stacking."""
    return tuple(p for p in parts if p not in ("layers", "groups", "rest")
                 and not str(p).isdigit())


def _jax_specs(tree_fn, arch, rules=None, **kw):
    import jax
    from repro.configs import get_arch as jax_get_arch
    from repro.models import init_params as jinit
    from repro.parallel import specs as jspecs

    js = _jax_rules()
    cfg = jax_get_arch(arch).reduced()
    params = jax.eval_shape(lambda: jinit(cfg, jax.random.PRNGKey(0), tp=4))
    with js.parallel_rules(js.mesh_axes(rules)):
        specs = tree_fn(jspecs, params, cfg, **kw)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        parts = [getattr(e, "key", getattr(e, "idx", None)) for e in path]
        out.setdefault(_key(parts), set()).add(tuple(spec))
    return out


def _same_spec(port, jax_specs):
    """The port's spec (its tensor's own rank) equals repro's trailing
    entries; repro's leading (stacking) entries are None."""
    n = len(port)
    return all(tuple(js[len(js) - n:]) == tuple(port) and not any(js[:len(js) - n])
               for js in jax_specs) if n else all(not any(js) for js in jax_specs)


@pytest.mark.parametrize("moe_impl", ["tp", "ep"])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_pspecs_equal_repro(arch, moe_impl):
    """Under the default rules and under a rule set that maps fsdp to the
    data axis; fsdp_dim names the dimension the latter splits."""
    from repro_torch.models import init_params
    from repro_torch.parallel.specs import fsdp_dim
    model = init_params(get_arch(arch).reduced(), torch.Generator().manual_seed(0), tp=4,
                        device="cpu", dtype=torch.float32)
    for rules in (None, {"fsdp": "data"}):
        want = _jax_specs(lambda m, p, cfg, **kw: m.param_pspecs(p, **kw), arch, rules,
                          moe_impl=moe_impl)
        with sharding.parallel_rules(sharding.mesh_axes(rules)):
            got = param_pspecs(model, moe_impl)
            dims = {n: fsdp_dim(n, p.dim(), moe_impl) for n, p in model.named_parameters()}
        assert len(got) == len(list(model.parameters()))
        for name, spec in got.items():
            assert _same_spec(spec, want[_key(name.split("."))]), (name, spec, rules)
            split = [i for i, ax in enumerate(spec) if ax == "data"]
            assert split == ([] if dims[name] is None else [dims[name]]), (name, rules)
        if arch == "mixtral":
            fs = "data" if rules else None
            assert got["layers.0.moe.w_up"] == ((("model", None, None)) if moe_impl == "ep"
                                                else (None, fs, "model"))
            assert got["embed"] == ("model", None) and got["layers.0.moe.router"] == (fs, None)
        if rules:
            assert any(spec[:1] == ("data",) for spec in got.values())


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("arch", ["starcoder2", "mamba2", "recurrentgemma", "whisper"])
def test_cache_pspecs_equal_repro(arch, seq_sharded):
    import jax
    from repro.models import init_cache as jcache
    from repro_torch.models import init_cache, init_params

    want = _jax_specs(lambda m, p, cfg, **kw: m.cache_pspecs(
        jax.eval_shape(lambda q: jcache(q, cfg, 2, 16), p), **kw), arch,
        seq_sharded=seq_sharded)
    cfg = get_arch(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), tp=4, device="cpu",
                        dtype=torch.float32)
    with sharding.parallel_rules(sharding.mesh_axes()):
        got = cache_pspecs(init_cache(model, 2, 16), seq_sharded)
    assert len(got) == cfg.num_layers
    for layer in got:
        for name, spec in layer.items():
            assert _same_spec(spec, want[(name,)]), (name, spec)


@pytest.mark.parametrize("opt_name", ["adamw", "adamw_lowmem"])
def test_opt_pspecs_mirror_param_specs(opt_name):
    """Under the default rules and with fsdp mapped to the data axis, and
    equal to repro's opt_pspecs for master, m and AdamW's v."""
    from repro_torch.models import init_params
    model = init_params(get_arch("mixtral").reduced(), torch.Generator().manual_seed(0),
                        tp=4, device="cpu", dtype=torch.float32)
    for rules in (None, {"fsdp": "data"}):
        with sharding.parallel_rules(sharding.mesh_axes(rules)):
            ps = param_pspecs(model)
            specs = opt_pspecs(ps, model, opt_name)
        assert specs["master"] == ps and specs["m"] == ps and specs["step"] == ()
        wq = ps["layers.0.attn.wq"]
        assert wq == (("data" if rules else None), "model")
        if opt_name == "adamw":
            assert specs["v"] == ps
        else:
            assert specs["v"]["layers.0.attn.wq"] == {"vr": wq[:-1], "vc": wq[-1:]}
            assert specs["v"]["layers.0.norm1.scale"] == {"v": ps["layers.0.norm1.scale"]}
        want = _jax_specs(lambda m, p, cfg: m.opt_pspecs(m.param_pspecs(p), p, opt_name),
                          "mixtral", rules)
        # repro stacks the layers, so its factored v of a 1-D leaf differs
        for name in ps:
            key = _key(name.split("."))
            for part in ("master", "m") + (("v",) if opt_name == "adamw" else ()):
                assert _same_spec(specs[part][name], want[(part,) + key]), (part, name)


@pytest.mark.parametrize("arch", ["mixtral", "starcoder2", "whisper"])
def test_tp_padded_init_and_tree_match_repro(arch):
    """``init_params(tp=4)`` pads heads as repro does, and
    ``params_from_jax`` carries repro's tp-padded tree: the unsharded
    forward on it equals JAX's."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.models import forward as jforward
    from repro.models import init_params as jinit
    from repro_torch.models import init_params

    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    tree = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0), tp=4, dtype=jnp.float32))
    model = params_from_jax(cfg, tree, device="cpu")
    mine = init_params(cfg, torch.Generator().manual_seed(0), tp=4, device="cpu",
                       dtype=torch.float32)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(p.shape) for n, p in mine.named_parameters()}
    assert model.layers[0].attn["wk"].shape[-1] == cfg.padded_kv_heads(4) * cfg.head_dim
    batch = synthetic_batch(cfg, 0, 2, 16)
    want = jforward(jax.tree.map(jnp.asarray, tree), jcfg,
                    {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    with torch.no_grad():
        got = forward(model, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=False)
    assert _err(got.numpy(), np.asarray(want)) <= TOL


def test_binary_exchange_raises_for_a_non_power_of_two_axis():
    three = Axis("model", (0, 1, 2), 0)
    with pytest.raises(ValueError, match="power-of-two"):
        C.binary_exchange_all_to_all(torch.zeros(3, 2), three)


def test_one_rank_axis_returns_inputs():
    one = Axis("model", (0,), 0)
    x = torch.arange(6.0).reshape(3, 2)
    for fn in (C.ring_all_reduce, C.ring_reduce_scatter, C.ring_all_gather,
               C.binary_exchange_all_to_all, C.all_to_all_baseline, C.copy_to, C.psum,
               C.split_to, C.gather_from):
        assert fn(x, one) is x
    assert torch.equal(C.pmax(x, one), x)
    assert torch.equal(C.ppermute(x, one, [(0, 0)]), x)
    with pytest.raises(ValueError, match="impl"):
        C.ring_all_reduce(x, one, impl="tree")


def test_shard_tensor_cuts_major_to_minor():
    """A dimension split over (pod, data) is cut pod-major, as a
    NamedSharding lays it out."""

    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.arange(16).reshape(2, 2, 4)

        def get_coordinate(self):
            return [1, 0, 3]

    t = torch.arange(8 * 8).reshape(8, 8)
    got = shard_tensor(t, (("pod", "data"), "model"), FakeMesh())
    assert torch.equal(got, t[4:6, 6:8])
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor(torch.zeros(6, 8), ("model", None), FakeMesh())


if __name__ == "__main__":
    _main(sys.argv[1])
