"""The port's dry run against ``repro``'s, on the CPU.

``repro_torch.launch.dryrun`` runs each cell's step as rank 0 of a fake
256- or 512-rank world on ``meta`` tensors, under
``repro_torch.launch.op_analysis.OpAnalysis``; ``repro.launch.dryrun``
compiles it for that many forced host devices.  This file holds:

* the shape cells, ``applicable_shapes`` and ``input_specs`` to ``repro``'s
  for every architecture and shape;
* the port's per-rank ``argument_bytes`` to ``memory.argument_bytes`` of
  ``repro``'s own ``run_cell`` (run in a subprocess, since the module sets
  ``XLA_FLAGS`` at import, with its ``RESULTS`` in a temporary directory) on
  three full-size cells of the single mesh;
* a ``meta`` dry run to a real run of the same step on 4 gloo ranks of
  the CPU (reduced StarCoder2 and Mamba2 at (2, 2), the default rules),
  started as ``python tests/test_torch_dryrun.py world``: FLOPs, traffic,
  transcendentals, collectives and kernel reports equal, the peak within
  ``PEAK_TOL``;
* the FLOPs of a reduced dense train step to a closed form written here;
* the port's collective wire bytes to ``repro.launch.hlo_analysis``'s on a
  hand-written HLO text, for every kind and group size;
* the CLI's cell list to ``repro``'s, and two decode cells' records (the
  merge's all-reduces over ``data`` in ``long_500k``'s, none in
  ``decode_32k``'s) and the ``kvdedup`` variant's through the CLI.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_arch, input_specs
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as A
from repro_torch.obs import op_counts
from repro_torch.parallel import collectives as C
from repro_torch.parallel.mesh import fake_world, make_mesh, mesh_axis, spawn_world
from repro_torch.parallel.sharding import mesh_axes, parallel_rules
from repro_torch.train import synthetic_batch

ROOT = Path(__file__).resolve().parents[1]

# the reference cells of argument_bytes (single mesh, full size)
REF_CELLS = [("starcoder2-3b", "train_4k"), ("mamba2-780m", "train_4k"),
             ("mixtral-8x7b", "prefill_32k")]
# repro's optimizer state holds its step as an int32 on the device (4 bytes
# of a train cell's arguments); the port's is a host int (train/optimizer.py)
STEP_BYTES = 4
# the meta and real runs: reduced configs at (2, 2), B = 2 a data shard
WORLD_ARCHS = ("starcoder2", "mamba2")
WORLD_SEQ = 32
WORLD_BATCH = 2
# The peak of live bytes of the meta run includes the kernels' scratch and
# saved state as the card allocates them (flash's delta and dK/dV partials,
# the SSD forward's chunk states and decays, the backward's state
# gradients), which the plain versions on the CPU do not make; every other
# tensor is the same.  Here the SSD states raise reduced Mamba2's peak by
# 13.4% (StarCoder2's flash scratch is gone before its peak: equal).
PEAK_TOL = 0.15


def _jnp_dtype(dt):
    import jax.numpy as jnp

    return {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
            torch.float32: jnp.float32}[dt]


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shapes_and_input_specs_equal_repro(arch, shape):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import applicable_shapes as japplicable
    from repro.configs import get_arch as jget
    from repro.configs import input_specs as jspecs

    assert dataclasses.asdict(SHAPES[shape]) == dataclasses.asdict(JSHAPES[shape])
    cfg, jcfg = get_arch(arch), jget(arch)
    names = [s.name for s in applicable_shapes(cfg)]
    assert names == [s.name for s in japplicable(jcfg)]
    if shape not in names:
        return
    for dt in (torch.bfloat16, torch.float32):
        got = input_specs(cfg, SHAPES[shape], dtype=dt)
        want = jspecs(jcfg, JSHAPES[shape], dtype=_jnp_dtype(dt))
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert _jnp_dtype(t.dtype) == want[k].dtype, k


def test_input_specs_take_a_rank_batch_and_a_device():
    cfg = get_arch("paligemma")
    got = input_specs(cfg, SHAPES["train_4k"], device="cpu", batch=16)
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        "tokens": (16, 4096 - 256), "labels": (16, 4096 - 256),
        "patches": (16, 256, cfg.d_model)}
    assert all(t.device.type == "cpu" for t in got.values())


# ------------------------------------------------------------------ argument bytes


@pytest.fixture(scope="module")
def repro_records(tmp_path_factory):
    """``repro``'s run_cell records of REF_CELLS, compiled in a subprocess
    with its RESULTS in a temporary directory."""
    out = tmp_path_factory.mktemp("repro_dryrun")
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "import repro.launch.dryrun as D\n"
        "D.RESULTS = Path(sys.argv[1])\n"
        "out = {}\n"
        "for arch, shape in json.loads(sys.argv[2]):\n"
        "    rec = D.run_cell(arch, shape, False, force=True)\n"
        "    out[arch + '--' + shape] = {k: rec.get(k) for k in\n"
        "        ('status', 'memory', 'error', 'num_devices')}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code, str(out), json.dumps(REF_CELLS)],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", REF_CELLS)
def test_argument_bytes_equal_repro_run_cell(arch, shape, repro_records, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    want = repro_records[f"{arch}--{shape}"]
    assert want["status"] == "ok", want["error"]
    rec = D.run_cell(arch, shape, False, force=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["num_devices"] == want["num_devices"] == 256
    step = STEP_BYTES if SHAPES[shape].kind == "train" else 0
    assert rec["memory"]["argument_bytes"] + step == want["memory"]["argument_bytes"]
    assert (tmp_path / "single" / f"{arch}--{shape}.json").exists()
    assert rec["memory"]["temp_bytes"] > 0 and rec["cost"]["flops"] > 0
    assert rec["loop_aware"]["collective_wire_bytes"] > 0


# ------------------------------------------------------------------ meta against real


def _world_batch(cfg, d):
    b = synthetic_batch(cfg, 0, 2 * WORLD_BATCH, WORLD_SEQ)
    rows = slice(d * WORLD_BATCH, (d + 1) * WORLD_BATCH)
    return {k: torch.from_numpy(v[rows].copy()) for k, v in b.items()}


def _cell_records(device, rank=0):
    """Each WORLD_ARCHS step's record at (2, 2) under the default rules, on
    ``device`` (``meta``: the dry run), and under the same mesh the
    prefill's next tokens and the unsharded prefill's (real runs only)."""
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    d = mesh_axis(mesh, "data").index
    for arch in WORLD_ARCHS:
        cfg = get_arch(arch).reduced()
        batch = _world_batch(cfg, d)
        if device == "meta":
            batch = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
        with parallel_rules(mesh_axes(), mesh):
            fn, args = D.train_step(cfg, mesh, batch, device=device, seed=3)
            _, rec = D.measure(fn, args)
            out[arch] = rec
            if device != "meta":
                model = D.sharded_model(cfg, mesh, device=device, seed=3)
                out[f"{arch}_prefill"] = D.prefill(model, batch).tolist()
        if device != "meta":
            full = D.sharded_model(cfg, None, device=device, seed=3)
            out[f"{arch}_prefill_unsharded"] = D.prefill(full, batch).tolist()
    return out


def _world_rank(rank):
    torch.set_num_threads(1)
    return _cell_records("cpu", rank)


def _main():
    torch.set_num_threads(1)
    real = spawn_world(_world_rank, 4, backend="gloo", timeout_s=300)
    with fake_world(4):
        meta = _cell_records("meta")
    print(json.dumps({"real": real, "meta": meta}))


@functools.lru_cache(maxsize=None)
def _world() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(Path(__file__)), "world"], capture_output=True,
                         text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", WORLD_ARCHS)
def test_meta_dry_run_counts_what_the_real_run_does(arch):
    r = _world()
    meta = r["meta"][arch]
    assert meta["cost"]["flops"] > 0 and meta["collectives"]
    kernels = {"starcoder2": {"flash_attention", "flash_attention_bwd"},
               "mamba2": {"ssd_scan", "ssd_scan_bwd"}}[arch]
    assert set(meta["kernels"]) == kernels
    for rank, real in enumerate(r["real"]):
        real = real[arch]
        assert real["cost"] == meta["cost"], rank
        assert real["loop_aware"] == meta["loop_aware"], rank
        assert real["collectives"] == meta["collectives"], rank
        assert real["collectives_issued_by"] == meta["collectives_issued_by"], rank
        assert real["kernels"] == meta["kernels"], rank
        assert real["memory"]["argument_bytes"] == meta["memory"]["argument_bytes"]
        assert real["memory"]["output_bytes"] == meta["memory"]["output_bytes"]
        peak, want = meta["memory"]["temp_bytes"], real["memory"]["temp_bytes"]
        assert want <= peak <= want * (1 + PEAK_TOL), (rank, peak, want)


@pytest.mark.parametrize("arch", WORLD_ARCHS)
def test_sharded_prefill_takes_the_unsharded_argmax(arch):
    r = _world()
    for real in r["real"]:
        assert real[f"{arch}_prefill"] == real[f"{arch}_prefill_unsharded"]
        assert len(real[f"{arch}_prefill"]) == WORLD_BATCH


# ------------------------------------------------------------------ closed form


def test_dense_train_flops_equal_the_closed_form():
    """Reduced StarCoder2 (GELU MLP, tied embedding) off a mesh: every
    projection's matmul runs forward and twice backward (the input's and
    the weight's gradient), and again in the remat recompute but for the
    MLP's down projection, whose output the backward does not need (the
    non-reentrant checkpoint stops recomputing after the last tensor the
    backward saved); the LM head forward and twice backward; flash forward
    twice a layer at 4 D FLOPs a kept pair and head, backward once at
    10 D."""
    cfg = get_arch("starcoder2").reduced()
    b, s = 2, 32
    batch = {k: torch.empty(b, s, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    fn, args = D.train_step(cfg, None, batch)
    _, rec = D.measure(fn, args)
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, kv = cfg.padded_heads(1), cfg.padded_kv_heads(1)
    layer = d * hq * hd + 2 * d * kv * hd + hq * hd * d + 2 * d * f
    head = d * cfg.padded_vocab()
    tokens = b * s
    remat = layer - f * d
    matmul = 2 * tokens * (cfg.num_layers * (layer * (1 + 2) + remat) + head * 3)
    pairs = b * hq * s * (s + 1) // 2
    flash = cfg.num_layers * (2 * 4 * pairs * hd + 10 * pairs * hd)
    assert rec["cost"]["flops"] == matmul + flash
    assert rec["loop_aware"]["dot_flops"] == matmul + flash
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * cfg.num_layers
    assert rec["kernels"]["flash_attention_bwd"]["calls"] == cfg.num_layers
    assert rec["collectives"] == {}


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=False),
                                  dict(causal=True, window=5), dict(causal=True, chunk=8),
                                  dict(causal=True, prefix_len=6),
                                  dict(causal=True, window=4, prefix_len=3),
                                  dict(causal=True, q_offset=7)])
def test_flash_kept_pairs_count_the_mask(mask):
    from repro_torch.kernels.flash_attention.flash_attention import kept_pairs
    from repro_torch.kernels.flash_attention.ref import flash_mask

    sq, sk = 13, 20
    q_pos = mask.get("q_offset", 0) + torch.arange(sq)
    keep = flash_mask(sq, sk, sk, 0, q_pos, causal=mask["causal"],
                      window=mask.get("window", 0), chunk=mask.get("chunk", 0),
                      prefix_len=mask.get("prefix_len", 0))
    full = {**dict(window=0, chunk=0, prefix_len=0, q_offset=0), **mask}
    assert kept_pairs(sq, sk, full["causal"], full["window"], full["chunk"],
                      full["prefix_len"], full["q_offset"]) == int(keep.sum())


# ------------------------------------------------------------------ wire bytes


def _hlo(kind, n, dtype):
    """A module with one collective of ``kind`` over groups of ``n``."""
    groups = "{{" + ",".join(str(i) for i in range(n)) + "}}"
    shapes = {"all-reduce": "[64,32]", "all-gather": f"[{64 * n},32]",
              "reduce-scatter": "[16,32]", "all-to-all": "[64,32]",
              "collective-permute": "[64,32]"}
    extra = ("source_target_pairs={{0,1},{1,0}}" if kind == "collective-permute"
             else f"replica_groups={groups}")
    return (f"HloModule m\n\nENTRY %main (p0: {dtype}[64,32]) -> {dtype}[64,32] {{\n"
            f"  %p0 = {dtype}[64,32] parameter(0)\n"
            f"  ROOT %c = {dtype}{shapes[kind]} {kind}({dtype}[64,32] %p0), {extra}\n}}\n")


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", op_counts.COLLECTIVE_KINDS)
def test_wire_bytes_equal_hlo_analysis(kind, dtype, n):
    from repro.launch.hlo_analysis import total_stats

    want = total_stats(_hlo(kind, n, dtype))
    shape = {"all-gather": (64 * n, 32), "reduce-scatter": (16, 32)}.get(kind, (64, 32))
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    with A.OpAnalysis() as an:
        op_counts.report_collective(kind, torch.empty(shape, dtype=tdt, device="meta"), n)
    got = an.total_stats()
    for key in ("collective_bytes", "collective_wire_bytes", "collective_wire_bytes_bf16",
                "collectives"):
        assert got[key] == want[key], key


def test_ring_collectives_report_their_permutes_on_meta():
    """A ring all-gather over 4 ranks of a fake world: 3 neighbour
    exchanges of the payload, issued by the ring all-gather; the ring
    all-reduce 6, issued by it; psum one all-reduce."""
    with fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
        ax = mesh_axis(mesh, "model")
        x = torch.empty((8, 6), device="meta")
        with A.OpAnalysis() as an:
            C.ring_all_gather(x, ax, 0)
            C.ring_all_reduce(x, ax)
            C.psum(x, ax)
    issued = an.issued_stats()
    assert issued["ring all-gather"]["collective-permute@4"]["count"] == 3
    assert issued["ring all-gather"]["collective-permute@4"]["bytes"] == 3 * 8 * 6 * 4
    assert issued["ring all-reduce"]["collective-permute@4"]["count"] == 6
    assert issued["all-reduce"]["all-reduce@4"]["count"] == 1


# ------------------------------------------------------------------ CLI


def test_cli_list_equals_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    outs = [subprocess.run([sys.executable, "-m", mod, "--list"], capture_output=True,
                           text=True, env=env, timeout=300, cwd=ROOT)
            for mod in ("repro.launch.dryrun", "repro_torch.launch.dryrun")]
    for res in outs:
        assert res.returncode == 0, res.stderr[-4000:]
    lines = outs[1].stdout.splitlines()
    assert lines == outs[0].stdout.splitlines()
    kinds = [SHAPES[ln.split()[1]].kind for ln in lines]
    assert len(lines) == 35
    assert (kinds.count("train"), kinds.count("prefill"), kinds.count("decode")) == (10, 10, 15)


@pytest.mark.parametrize("cell, merges", [(("mixtral-8x7b", "long_500k"), 2),
                                          (("starcoder2-3b", "decode_32k"), 0)])
def test_decode_cell_records_ok_with_the_merge_over_data(cell, merges, tmp_path, monkeypatch):
    """A decode cell runs ``decode_step`` on rank 0's shards: ``long_500k``'s
    one lane does not divide the data axis, so its cache's sequence is
    split over ``data`` and every attention layer merges its partial
    attention there (a pmax and a psum); ``decode_32k`` splits its lanes
    over ``data`` and reduces nothing over it."""
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    axes = []
    real = C._all_reduce

    def spy(x, group, *args, **kwargs):
        axes.append(group.name)
        return real(x, group, *args, **kwargs)

    monkeypatch.setattr(C, "_all_reduce", spy)
    rec = D.run_cell(*cell, False, force=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["seq_sharded"] == bool(merges) and rec["kv_pad"]
    assert rec["kernels"]["decode_attention"]["calls"] == get_arch(cell[0]).num_layers
    assert rec["collectives"]["all-reduce"]["count"] == len(axes)
    assert axes.count("data") == merges * get_arch(cell[0]).num_layers
    assert rec["memory"]["argument_bytes"] > 0


def test_kvdedup_variant_runs_a_decode_cell(tmp_path, monkeypatch):
    """``--variant kvdedup``: the KV heads unpadded and whole, the cache's
    sequence split over ``model``; StarCoder2-3B's 2 KV heads over 2048 slots
    a rank hold a quarter of the baseline's padded head over 32768."""
    monkeypatch.setattr(D, "RESULTS", tmp_path / "dryrun_torch")
    base = D.run_cell("starcoder2-3b", "decode_32k", False, force=True)
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "starcoder2", "--shape",
                                      "decode_32k", "--mesh", "single", "--variant",
                                      "kvdedup"])
    with pytest.raises(SystemExit) as exit_:
        D.main()
    assert exit_.value.code == 0
    rec = json.loads((tmp_path / "dryrun_torch_kvdedup" / "single" /
                      "starcoder2-3b--decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["seq_sharded"] and not rec["kv_pad"]
    # each layer gathers the query heads over model: a ring of 15 sends
    gathered = rec["collectives_issued_by"]["ring all-gather"]["collective-permute@16"]
    assert gathered["count"] == 15 * get_arch("starcoder2").num_layers
    assert rec["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]


def test_analysis_releases_the_arguments_after_the_step():
    """A tensor made under the analysis that outlives the step (the step's
    outputs here, a cached table in general) keeps neither the analysis nor
    the arguments' storages it holds alive."""
    import gc
    import weakref

    from repro_torch.models import decode_step, forward, init_cache, init_params

    model = init_params(get_arch("starcoder2").reduced(), torch.Generator().manual_seed(0),
                        device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    cache = init_cache(model, 2, 8)
    tok, pos = torch.zeros((2, 1), dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        h, rec = D.measure(lambda: forward(model, batch, remat=False), (model, batch))
    (nxt, _), _ = D.measure(lambda: decode_step(model, cache, tok, pos), (model, cache))
    assert rec["memory"]["argument_bytes"] > 0
    gc.collect()
    assert not any(isinstance(o, A.OpAnalysis) for o in gc.get_objects())
    gone = weakref.ref(model.embed)
    del model, cache, _
    gc.collect()
    assert gone() is None and h.shape == (1, 8, get_arch("starcoder2").reduced().d_model)
    assert nxt.shape == (2,)


def test_sharded_prefill_runs_the_variant_moe_mode():
    """The moe-ep variant's prefill cells run the MoE layers in ep mode on
    the expert shards (reduced Llama-4 at (1, 4) on meta tensors): with the
    default tp mode the (E/tp, d, f) shards do not multiply the (E, C, d)
    buffer."""
    cfg = get_arch("llama4").reduced()
    with fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
        with parallel_rules(mesh_axes(), mesh):
            model = D.sharded_model(cfg, mesh, "ep")
            batch = {"tokens": torch.empty((1, 16), dtype=torch.int32, device="meta")}
            nxt = D.prefill(model, batch, {"moe_impl": "ep"})
            with pytest.raises(RuntimeError):
                D.prefill(model, batch)
    assert nxt.device.type == "meta" and nxt.shape == (1,)


if __name__ == "__main__":
    if sys.argv[1:] == ["world"]:
        _main()


def test_lower_layers_do_not_import_the_entry_points():
    """Kernel wrappers, collectives, models and the train loop report to the
    analysis through ``repro_torch.obs.op_counts`` and import nothing of
    ``repro_torch.launch``."""
    code = ("import sys\n"
            "import repro_torch.kernels.flash_attention.flash_attention\n"
            "import repro_torch.kernels.ssd_scan.ssd_scan\n"
            "import repro_torch.parallel.collectives, repro_torch.models.transformer\n"
            "import repro_torch.train.loop, repro_torch.train.optimizer\n"
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.launch')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
