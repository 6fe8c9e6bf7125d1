"""The port's ``decode_step`` under a mesh against the unsharded JAX
``decode_step``, on the CPU.

``repro`` decodes under its mesh with GSPMD partitioning the step, and the
softmax of a cache whose sequence is split; the port runs one process per
rank over ``torch.distributed`` (gloo): tensor-parallel heads, MLP, MoE,
SSD and RG-LRU layers reduced over the model axis, the logits
vocab-parallel, and a sequence-sharded cache attended in the flash-decode
kernel's log-sum-exp form (here its plain version) and merged across the
axis.  One world of 4 ranks, started as

    python tests/test_torch_parallel_decode.py world

computes the unsharded JAX references first (each reduced config
initialised for ``tp=4``, float32, every zero- or one-initialised vector
drawn from a seed; ``kv_pad=False`` for the ``kvdedup`` runs), then spawns
the ranks, which decode the same teacher-forced token streams and report
in one JSON line:

* reduced StarCoder2 (KV heads padded 2 -> 4), Mixtral (sliding window,
  MoE in ``tp`` mode), Llama-4 (chunked and global attention, a shared
  expert), Mamba-2 (SSD), RecurrentGemma (RG-LRU and windowed MQA) and
  Whisper (cross-attention to a cache filled by ``encode_to_cache`` under
  the mesh) at meshes (1, 4) and (2, 2), 4 lanes at different positions;
* StarCoder2, Mixtral and Llama-4 at (4, 1) with one lane and the cache's
  sequence split over ``data`` (``long_500k``'s layout), positions past
  the 32-slot window of Mixtral's ring and Llama-4's chunks, so that the
  ring wraps, the writing rank rotates and a chunk's slots lie on several
  ranks;
* Llama-4 at (1, 4) with its MoE layers in ``ep`` mode (experts over the
  model axis, the shared expert over ``ff``) at capacity factor 4 (E /
  top_k: no assignment drops), against JAX at the same factor, with the
  default rules and under ``kvdedup``'s (the cache's sequence over
  ``model``);
* StarCoder2 and Mixtral under ``kvdedup`` at (1, 4): KV heads unpadded
  and whole on every rank, the sequence split over ``model``, the query
  heads gathered over it.

Every step's next tokens must equal JAX's, and every rank's cache shard
(``shard_cache`` of JAX's cache under ``cache_pspecs``) must hold JAX's
values within CACHE_TOL of their largest entry.  The MoE layers dispatch
within each data shard, as ``repro``'s do under a mesh, so a config with
experts is held at (2, 2) to JAX run on each data shard's lanes.
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
from repro_torch.models import transformer as TM
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import make_mesh, mesh_axis, spawn_world
from repro_torch.parallel.specs import cache_pspecs, shard_cache
from test_torch_parallel_recurrent import _err, _perturb

ROOT = Path(__file__).resolve().parents[1]

# float32 on both sides: the shards sum in another order than the unsharded
# model and the all-reduces add the shards, which moves the cached k/v and
# states by ~1e-6 of their largest entry over the steps
CACHE_TOL = 2e-5
LANES = 4
STEPS = 40
MAX_LEN = 64
OFFSETS = (0, 3, 5, 9)          # each lane's first position
SEQ_LANE = 3                    # the one lane of the (4, 1) runs: positions 9..48
ARCHS = ("starcoder2", "mixtral", "llama4", "mamba2", "recurrentgemma", "whisper")
# (arch, mesh, mode): "tp" the default rules, "seq" the cache's sequence
# over data with the batch replicated, "kvdedup" repro's variant, "ep" the
# default rules with the MoE layers in ep mode
RUNS = [(arch, shape, "tp") for arch in ARCHS for shape in ((1, 4), (2, 2))]
RUNS += [(arch, (4, 1), "seq") for arch in ("starcoder2", "mixtral", "llama4")]
RUNS += [(arch, (1, 4), "kvdedup") for arch in ("starcoder2", "mixtral")]
RUNS += [("llama4", (1, 4), "ep"), ("llama4", (1, 4), "ep_kvdedup")]
MODE_RULES = {"tp": {}, "seq": {"batch": None},
              "kvdedup": {"kv_heads": None, "seq_shard": "model"}, "ep": {},
              "ep_kvdedup": {"kv_heads": None, "seq_shard": "model"}}
SEQ_MODES = ("seq", "kvdedup", "ep_kvdedup")      # the cache's sequence split
EP_CF = 4.0                     # E / top_k of reduced Llama-4: no assignment drops


def _tag(arch, shape, mode):
    return f"{arch}_{shape[0]}x{shape[1]}_{mode}"


RUN_TAGS = [_tag(*r) for r in RUNS]


def _stream(cfg):
    """Teacher-forced tokens (LANES, STEPS), each lane's positions (LANES,
    STEPS) and Whisper's float32 frames, from a seed."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (LANES, STEPS)).astype(np.int32)
    pos = (np.asarray(OFFSETS, np.int32)[:, None] + np.arange(STEPS, dtype=np.int32))
    frames = (rng.standard_normal((LANES, cfg.enc_seq, cfg.d_model)).astype(np.float32)
              if cfg.enc_seq else None)
    return tokens, pos, frames


# ------------------------------------------------------------------ references


def _jax_layers(jcache, num_layers):
    """JAX's per-layer caches in layer order (stacked group slots, then
    rest) as float32 or int32 numpy arrays."""
    groups, rest = jcache["groups"], jcache["rest"]
    cycle = len(groups)
    n_groups = len(next(iter(groups[0].values()))) if cycle else 0
    out = {g * cycle + s: {k: np.asarray(v[g]) for k, v in slot.items()}
           for s, slot in enumerate(groups) for g in range(n_groups)}
    out.update({n_groups * cycle + j: {k: np.asarray(v) for k, v in c.items()}
                for j, c in enumerate(rest)})
    return [out[i] for i in range(num_layers)]


@functools.lru_cache(maxsize=None)
def _jit(fn):
    """``fn`` jitted once with its config argument static, so that lane
    groups of one shape share a compile."""
    import jax

    return jax.jit(fn, static_argnums=(1,))


def _jax_decode(jcfg, params, lanes, tokens, pos, frames):
    """JAX's decode of ``lanes``: next tokens (len(lanes), STEPS) and the
    final per-layer caches."""
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import decode_step, encode_to_cache, init_cache

    cache = init_cache(params, jcfg, len(lanes), MAX_LEN, dtype=jnp.float32)
    if frames is not None:
        cache = encode_to_cache(params, jcfg, cache, jnp.asarray(frames[lanes]))
    step = _jit(decode_step)
    out = []
    for t in range(STEPS):
        nxt, cache = step(params, jcfg, cache, jnp.asarray(tokens[lanes, t:t + 1]),
                          jnp.asarray(pos[lanes, t]))
        out.append(np.asarray(nxt))
    return np.stack(out, 1), _jax_layers(cache, jcfg.num_layers)


def _cat_lanes(parts):
    """Per-layer caches of lane groups joined along the batch."""
    return [{k: np.concatenate([p[i][k] for p in parts]) for k in parts[0][i]}
            for i in range(len(parts[0]))]


def _cfg(get, arch, mode):
    """The reduced config of a run: at EP_CF in ep mode."""
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, capacity_factor=EP_CF) if mode.startswith("ep") else cfg


def _ref_key(arch, mode):
    return arch, mode.endswith("kvdedup"), mode.startswith("ep")


def _jax_refs(arch, kv_pad, ep=False):
    """The references of one config: its tree, the stream, and JAX's tokens
    and caches for every lane group a run holds (``ep``: at EP_CF)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.models import init_params as jinit

    jcfg = _cfg(jax_get_arch, arch, "ep" if ep else "tp")
    tree = _perturb(jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0), tp=4,
                                                   dtype=jnp.float32, kv_pad=kv_pad)),
                    seed=13)
    params = jax.tree.map(jnp.asarray, tree)
    tokens, pos, frames = _stream(jcfg)
    groups = {"all": list(range(LANES))}
    if jcfg.n_experts:       # dispatch is local to a data shard
        groups.update(half0=[0, 1], half1=[2, 3], seq=[SEQ_LANE])
    res = {k: _jax_decode(jcfg, params, lanes, tokens, pos, frames)
           for k, lanes in groups.items()}
    if not jcfg.n_experts:
        toks, layers = res["all"]
        res["seq"] = (toks[SEQ_LANE:SEQ_LANE + 1],
                      [{k: v[SEQ_LANE:SEQ_LANE + 1] for k, v in c.items()} for c in layers])
    if "half0" in res:
        res["halves"] = (np.concatenate([res["half0"][0], res["half1"][0]]),
                         _cat_lanes([res["half0"][1], res["half1"][1]]))
    return {"tree": tree, "tokens": tokens, "pos": pos, "frames": frames,
            "ref": {k: v for k, v in res.items() if k in ("all", "halves", "seq")}}


# ------------------------------------------------------------------ ranks


def _check_run(arch, shape, mode, refs, out):
    tcfg = _cfg(get_arch, arch, mode)
    tag = _tag(arch, shape, mode)
    r = refs[_ref_key(arch, mode)]
    moe_impl = "ep" if mode.startswith("ep") else "tp"
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    seq = mode in SEQ_MODES
    if mode == "seq":
        rows, key = slice(SEQ_LANE, SEQ_LANE + 1), "seq"
    else:
        dax = mesh_axis(mesh, "data")
        per = LANES // dax.size
        rows = slice(dax.index * per, (dax.index + 1) * per)
        key = "halves" if shape[0] > 1 and "halves" in r["ref"] else "all"
    want_tokens, want_cache = r["ref"][key]
    full = params_from_jax(tcfg, r["tree"], device="cpu")
    with sharding.parallel_rules(sharding.mesh_axes(MODE_RULES[mode]), mesh):
        model = shard_params(full, mesh, moe_impl)
        cache = TM.init_cache(model, rows.stop - rows.start, MAX_LEN, dtype=torch.float32,
                              seq_sharded=seq)
        if r["frames"] is not None:
            TM.encode_to_cache(model, cache, torch.from_numpy(r["frames"][rows].copy()))
        got = []
        for t in range(STEPS):
            nxt, _ = TM.decode_step(model, cache, r["tokens"][rows, t:t + 1],
                                    r["pos"][rows, t], moe_ctx={"moe_impl": moe_impl},
                                    seq_sharded=seq)
            got.append(nxt.numpy())
        got = np.stack(got, 1)
        ref_rows = slice(0, 1) if mode == "seq" else rows
        out[f"{tag}_tokens_equal"] = bool(np.array_equal(got, want_tokens[ref_rows]))
        specs = cache_pspecs([{k: torch.from_numpy(v) for k, v in c.items()}
                              for c in want_cache], seq)
        want = shard_cache([{k: torch.from_numpy(v) for k, v in c.items()} for c in want_cache],
                           specs, mesh)
    worst, worst_name, shapes_ok, pos_ok = 0.0, "", True, True
    for i, (g, w) in enumerate(zip(cache, want)):
        if sorted(g) != sorted(w):
            shapes_ok = False
            continue
        for name in g:
            a, b = g[name].numpy(), w[name].numpy()
            if a.shape != b.shape:
                shapes_ok = False
            elif name == "pos":
                pos_ok &= bool(np.array_equal(a, b))
            elif (e := _err(a, b)) > worst:
                worst, worst_name = e, f"{i}.{name}"
    out[f"{tag}_cache_err"] = worst
    out[f"{tag}_cache_worst"] = worst_name
    out[f"{tag}_cache_shapes"] = shapes_ok
    out[f"{tag}_pos_equal"] = pos_ok
    out[f"{tag}_local"] = {k: list(v.shape) for k, v in cache[0].items()}


def _world(rank, refs):
    torch.set_num_threads(1)
    out = {}
    for arch, shape, mode in RUNS:
        _check_run(arch, shape, mode, refs, out)
    return out


def _main():
    torch.set_num_threads(1)
    keys = dict.fromkeys(_ref_key(arch, mode) for arch, _, mode in RUNS)
    refs = {(arch, dedup, ep): _jax_refs(arch, kv_pad=not dedup, ep=ep)
            for arch, dedup, ep in keys}
    outs = spawn_world(_world, 4, refs, backend="gloo", timeout_s=300)
    merged = {}
    for key in outs[0]:
        vals = [o[key] for o in outs]
        if isinstance(vals[0], bool):
            merged[key] = all(vals)
        elif isinstance(vals[0], float):
            merged[key] = max(vals)
        else:
            merged[key] = vals
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
def test_sharded_decode_matches_unsharded_jax(run):
    r = _results()
    assert r[f"{run}_tokens_equal"]
    assert r[f"{run}_cache_shapes"] and r[f"{run}_pos_equal"]
    assert r[f"{run}_cache_err"] <= CACHE_TOL, r[f"{run}_cache_worst"]


@pytest.mark.parametrize("run", RUN_TAGS)
def test_each_rank_holds_its_cache_shard(run):
    """The first layer's cache on each rank has the shard's shape: its
    lanes, its KV heads (StarCoder2's 4 padded heads split over the model
    axis, kvdedup's 2 whole), its SSD heads and RG-LRU channels, and under
    a sequence split a quarter of the slots."""
    arch, shape, mode = RUNS[RUN_TAGS.index(run)]
    cfg = get_arch(arch).reduced()
    local = _results()[f"{run}_local"]
    lanes = 1 if mode == "seq" else LANES // shape[0]
    tp = shape[1]
    for shapes in local:
        if cfg.layer_pattern[0] == "ssd":
            assert shapes["state"] == [lanes, cfg.ssm_heads // tp, cfg.ssm_state,
                                       cfg.ssm_head_dim]
            assert shapes["conv_x"] == [lanes, cfg.conv_width - 1, cfg.d_inner // tp]
        elif cfg.layer_pattern[0] == "rglru":
            assert shapes["h"] == [lanes, cfg.rnn_width // tp]
        else:
            slots = min(MAX_LEN, cfg.window or MAX_LEN) // (4 if mode in SEQ_MODES else 1)
            heads = (cfg.n_kv_heads if mode.endswith("kvdedup")
                     else cfg.padded_kv_heads(4) // tp)
            assert shapes["k"] == [lanes, slots, heads, cfg.head_dim]
            assert shapes["pos"] == [lanes, slots]


if __name__ == "__main__":
    if sys.argv[1:] == ["world"]:
        _main()
