"""The port's recurrent layers, encoder-decoder and prefix-LM models and
``adamw_lowmem`` under a model axis, against the unsharded JAX package, on
the CPU.

``repro`` shards the SSD and RG-LRU blocks over its mesh with GSPMD; the
port runs one process per rank over ``torch.distributed`` (gloo) and
reduces what GSPMD would (the gated norm's squares over the model axis, the
replicated B/C leaves' gradients, the blocks' partial outputs).  One world
of 4 ranks, started as

    python tests/test_torch_parallel_recurrent.py world

computes the unsharded JAX references first (each reduced config
initialised for ``tp=4``, float32, with every bias, norm scale and zero
initialised vector drawn from a seed so that every parameter matters), then
spawns the ranks, which compare their shards with them and report errors in
one JSON line:

* reduced Mamba-2 and RecurrentGemma at meshes (1, 4) and (2, 2), under the
  default rules (sequence parallelism over ``model``) and with ``seq_sp``
  unmapped: hidden states, loss and every gradient (the replicated ``w_B``,
  ``w_C`` and B/C conv leaves among them);
* reduced Whisper and PaliGemma at (1, 4) under sequence parallelism:
  hidden states, loss and every gradient (``enc.*``, ``normx`` and
  ``xattn`` among Whisper's);
* three ``adamw_lowmem`` steps of reduced Mamba-2 and RecurrentGemma at
  (2, 2) against ``repro``'s unsharded ``adamw_lowmem``, with a plain second
  moment for the per-layer vectors that ``repro`` factors across its
  stacked layers (``tests/test_torch_train.py``).
"""

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
from repro_torch.models import transformer as TM
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import make_mesh, mesh_axis, spawn_world
from repro_torch.parallel.specs import param_pspecs, shard_tensor
from repro_torch.train import OptConfig, TrainConfig, init_opt_state, make_train_step
from repro_torch.train import synthetic_batch

ROOT = Path(__file__).resolve().parents[1]

# float32 on both sides, PR 27's sharded tolerances (tests/test_torch_parallel.py):
# a shard sums in another order than the unsharded model and the all-reduces
# add the shards, so activations and the loss agree to ~1e-6 relative and
# gradients to ~1e-5 of their largest entry; 1e-4 holds either.  Three Adam
# steps move each weight by ~lr whatever its gradient's size.
TOL = 1e-4
PARAM_TOL = 1e-4
ADAM_EPS = 1e-6
SEQ = 32
# (arch, mesh, rules): "sp" the default rules, "nosp" with seq_sp unmapped
MODEL_RUNS = [(arch, shape, rules) for arch in ("mamba2", "recurrentgemma")
              for shape in ((1, 4), (2, 2)) for rules in ("sp", "nosp")]
MODEL_RUNS += [("whisper", (1, 4), "sp"), ("paligemma", (1, 4), "sp")]
LOWMEM_ARCHS = ("mamba2", "recurrentgemma")
RULES = {"sp": {}, "nosp": {"seq_sp": None}}
# leaves replicated over the model axis whose gradients the ranks sum
REPLICATED = ("w_B", "w_C", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b")
# zero- or one-initialised vectors drawn from a seed, so that every
# parameter reaches the loss with its own value
PERTURBED = ("bq", "bk", "bv", "bias", "scale", "norm_scale", "dt_bias", "D", "conv_x_b",
             "conv_B_b", "conv_C_b", "b_r", "b_i", "conv_b")


def _tag(arch, shape, rules):
    return f"{arch}_{shape[0]}x{shape[1]}" + ("" if rules == "sp" else f"_{rules}")


RUN_TAGS = [_tag(*r) for r in MODEL_RUNS]


def _err(got, want) -> float:
    """Max abs error over the reference's largest entry (1e-3 at least)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max() / max(1e-3, np.abs(want).max())) if want.size else 0.0


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(x, name=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, name) for v in x]
        a = np.array(x, copy=True)
        if name in PERTURBED:
            base = 1.0 if name == "D" else 0.0
            return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(tree)


# ------------------------------------------------------------------ references


def _jax_model(arch):
    """The unsharded JAX references of one reduced config, tp-padded for 4
    ranks: hidden states, loss and every gradient of batch 0; for the
    recurrent configs three ``adamw_lowmem`` steps."""
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
    tree = _perturb(jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(0), tp=4,
                                                   dtype=jnp.float32)), seed=13)
    batches = [synthetic_batch(get_arch(arch).reduced(), i, 4, SEQ) for i in range(3)]
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(p):
        h = jf(p, cfg, jb, remat=False)
        # a VLM's prefix rows carry no label (repro's train loop cuts them)
        return jl(p, cfg, h[:, h.shape[1] - jb["labels"].shape[1]:], jb["labels"]), h

    (loss, h), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref = {"tree": tree, "batches": batches, "h": np.asarray(h), "loss": float(loss),
           "grads": jax.tree.map(np.asarray, grads)}
    if arch in LOWMEM_ARCHS:
        opt = JOC(name="adamw_lowmem", lr=3e-3, warmup_steps=2, eps=ADAM_EPS)
        state = jopt(params, opt)
        # the per-layer vectors of the stacked groups get a plain second
        # moment, as the port gives every vector (tests/test_torch_train.py)
        state["v"]["groups"] = jax.tree.map(
            lambda p, v: {"v": jnp.zeros_like(p, jnp.float32)} if p.ndim == 2 else v,
            params["groups"], state["v"]["groups"],
            is_leaf=lambda x: isinstance(x, dict) and ("vr" in x or "v" in x))
        state = {"params": params, "opt": state}
        step = jax.jit(jstep(cfg, JTC(opt=opt, remat=False)))
        losses, norms = [], []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        ref.update(losses=losses, norms=norms,
                   final=jax.tree.map(np.asarray, state["params"]))
    return ref


def _named(tcfg, tree):
    return {n: p.detach() for n, p in
            params_from_jax(tcfg, tree, device="cpu").named_parameters()}


def _split_over(spec):
    return {a for ax in spec if ax is not None for a in (ax if isinstance(ax, tuple) else (ax,))}


# ------------------------------------------------------------------ ranks


def _check_model(arch, shape, rules, ref, out):
    tcfg = get_arch(arch).reduced()
    tag = _tag(arch, shape, rules)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    dax = mesh_axis(mesh, "data")
    per = 4 // shape[0]
    rows = slice(dax.index * per, (dax.index + 1) * per)
    full = params_from_jax(tcfg, ref["tree"], device="cpu")
    with sharding.parallel_rules(sharding.mesh_axes(RULES[rules]), mesh):
        specs = param_pspecs(full)
        model = shard_params(full, mesh)
        b0 = {k: torch.from_numpy(v[rows].copy()) for k, v in ref["batches"][0].items()}
        h = forward(model, b0, remat=True)
        out[f"{tag}_hidden_rows"] = h.shape[1]
        out[f"{tag}_hidden_err"] = _err(TM.full_sequence(h, ref["h"].shape[1]).detach().numpy(),
                                        ref["h"][rows])
        loss = lm_loss(model, h, b0["labels"])
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        total = loss.detach().clone()
        if dax.size > 1:
            torch.distributed.all_reduce(total, group=dax.group)
        out[f"{tag}_loss_err"] = abs(float(total) / shape[0] - ref["loss"]) / abs(ref["loss"])
        want = _named(tcfg, ref["grads"])
        worst, worst_name, rep = 0.0, "", 0.0
        for name, g in zip(names, grads):
            g = g.clone()
            if dax.size > 1:
                torch.distributed.all_reduce(g, group=dax.group)
            e = _err(g.numpy() / shape[0], shard_tensor(want[name], specs[name], mesh).numpy())
            if e > worst:
                worst, worst_name = e, name
            if name.split(".")[-1] in REPLICATED:
                rep = max(rep, e)
        out[f"{tag}_grads_err"] = worst
        out[f"{tag}_grads_worst"] = worst_name
        out[f"{tag}_replicated_err"] = rep
        out[f"{tag}_names"] = sorted(names)
        out[f"{tag}_n_split"] = sum(1 for n in names if "model" in _split_over(specs[n]))


def _check_lowmem(arch, ref, out):
    tcfg = get_arch(arch).reduced()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    dax = mesh_axis(mesh, "data")
    rows = slice(dax.index * 2, dax.index * 2 + 2)
    full = params_from_jax(tcfg, ref["tree"], device="cpu")
    opt = OptConfig(name="adamw_lowmem", lr=3e-3, warmup_steps=2, eps=ADAM_EPS)
    with sharding.parallel_rules(sharding.mesh_axes(), mesh):
        specs = param_pspecs(full)
        model = shard_params(full, mesh)
        state = {"params": model, "opt": init_opt_state(model, opt)}
        out[f"{arch}_lowmem_factored"] = sum(1 for v in state["opt"]["v"].values() if "vr" in v)
        step = make_train_step(tcfg, TrainConfig(opt=opt))
        losses, norms = [], []
        for b in ref["batches"]:
            state, m = step(state, {k: torch.from_numpy(v[rows].copy()) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{arch}_lowmem_loss_err"] = max(abs(a - b) / abs(b)
                                             for a, b in zip(losses, ref["losses"]))
        out[f"{arch}_lowmem_norm_err"] = max(abs(a - b) / abs(b)
                                             for a, b in zip(norms, ref["norms"]))
        final = _named(tcfg, ref["final"])
        out[f"{arch}_lowmem_params_err"] = max(
            float(np.abs(p.detach().numpy() - shard_tensor(final[n], specs[n], mesh).numpy()).max())
            for n, p in model.named_parameters())


def _world(rank, refs):
    torch.set_num_threads(1)
    out = {}
    for arch, shape, rules in MODEL_RUNS:
        _check_model(arch, shape, rules, refs[arch], out)
    for arch in LOWMEM_ARCHS:
        _check_lowmem(arch, refs[arch], out)
    return out


def _main():
    torch.set_num_threads(1)
    refs = {arch: _jax_model(arch) for arch in dict.fromkeys(a for a, _, _ in MODEL_RUNS)}
    outs = spawn_world(_world, 4, refs, backend="gloo", timeout_s=300)
    merged = {}
    for key in outs[0]:
        vals = [o[key] for o in outs]
        merged[key] = max(vals) if isinstance(vals[0], float) else vals
    print(json.dumps(merged))


@functools.lru_cache(maxsize=None)
def _results() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, str(Path(__file__)), "world"], capture_output=True,
                         text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("run", RUN_TAGS)
def test_sharded_model_matches_unsharded_jax(run):
    r = _results()
    assert r[f"{run}_hidden_err"] <= TOL
    assert r[f"{run}_loss_err"] <= TOL
    assert r[f"{run}_grads_err"] <= TOL, r[f"{run}_grads_worst"]


@pytest.mark.parametrize("run", [t for t in RUN_TAGS if t.startswith("mamba2")])
def test_replicated_ssd_leaves_get_the_whole_gradient(run):
    """w_B, w_C and the B/C convs are replicated over the model axis; each
    rank's heads give a part of their gradient, summed over the axis."""
    r = _results()
    names = r[f"{run}_names"][0]
    assert all(any(n.endswith("ssd." + leaf) for n in names) for leaf in REPLICATED)
    assert r[f"{run}_replicated_err"] <= TOL


@pytest.mark.parametrize("run", RUN_TAGS)
def test_sharded_residual_and_leaves(run):
    """The hidden states hold ceil(S / tp) rows under sequence parallelism
    and all S with seq_sp unmapped; the model axis splits leaves of every
    kind the config has (Whisper's encoder and cross-attention among
    them)."""
    arch, shape, rules = MODEL_RUNS[RUN_TAGS.index(run)]
    r = _results()
    rows = SEQ if rules == "nosp" else -(-SEQ // shape[1])
    assert r[f"{run}_hidden_rows"] == [rows] * 4
    assert all(n > 0 for n in r[f"{run}_n_split"])
    names = r[f"{run}_names"][0]
    parts = {"mamba2": ["ssd.w_x", "ssd.A_log"], "recurrentgemma": ["rglru.lam", "attn.wq"],
             "whisper": ["enc.layers.0.attn.wq", "xattn.wk", "normx.scale"],
             "paligemma": ["attn.wq", "mlp.w_up"]}[arch]
    assert all(any(p in n for n in names) for p in parts)


@pytest.mark.parametrize("arch", LOWMEM_ARCHS)
def test_sharded_adamw_lowmem_steps_match_jax(arch):
    r = _results()
    assert all(n > 0 for n in r[f"{arch}_lowmem_factored"])
    assert r[f"{arch}_lowmem_loss_err"] <= TOL
    assert r[f"{arch}_lowmem_norm_err"] <= TOL
    assert r[f"{arch}_lowmem_params_err"] <= PARAM_TOL


if __name__ == "__main__":
    if sys.argv[1:] == ["world"]:
        _main()
