"""The port's MoE MLP (``repro_torch.models.moe``) against ``repro.models.moe``
on the CPU, on the same seeded weights and tokens.

Reduced configs with 4 experts: Mixtral's SwiGLU experts (top-2), Llama-4
Maverick's SwiGLU experts with a shared expert (top-1) and GPT-MoE's GELU
experts without a gate (top-2), each also at capacity factor 0.5, where
assignments are dropped.  Routing (experts, ranks, kept assignments) must
equal JAX's exactly; values agree within the forward tolerance of
``tests/test_torch_train.py``.  The model-level checks of the MoE configs
are in ``tests/test_torch_windowed.py``.

``ep`` mode over a model axis runs in one world of 4 gloo ranks, started
as ``python tests/test_torch_moe.py world`` (it computes ``repro``'s
references in ``shard_map`` over 4 forced host devices first and prints
one JSON line): Llama-4's shared expert at mesh (2, 2) against the
unsharded port and ``repro``'s ``tp`` mode, and the routed part with
fewer tokens than ranks, or a count the ranks do not divide, at (1, 4)
against ``repro``'s ``ep`` body.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_arch as jax_get_arch
from repro.models import moe as jax_moe
from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.parallel.mesh import Axis

ACT_TOL = 2e-5            # float32 forward, as tests/test_torch_train.py
GRAD_TOL = 2e-5           # of the gradient's largest entry
BF16_TOL = 2e-2           # tests/test_kernels.py's bf16 tolerance

CASES = [(arch, cf) for arch in ("mixtral", "llama4", "gpt-moe") for cf in (1.25, 0.5)]


def _cfgs(arch, capacity_factor):
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), capacity_factor=capacity_factor)
    return jcfg, tcfg


def _pair(arch, capacity_factor, dtype=jnp.float32, seed=0):
    """(JAX config, JAX params, port config, port MoE, tokens (2, 24, d))."""
    jcfg, tcfg = _cfgs(arch, capacity_factor)
    jp = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype))

    def to_torch(v):
        if isinstance(v, dict):
            return {k: to_torch(x) for k, x in v.items()}
        if v.dtype.name == "bfloat16":
            return torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(v.copy())

    x = np.random.default_rng(seed + 1).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    return jcfg, jp, tcfg, moe.MoE(**to_torch(jp)), x


@pytest.mark.parametrize("arch,capacity_factor", CASES)
def test_dispatch_routes_like_jax(arch, capacity_factor):
    jcfg, jp, tcfg, p, x = _pair(arch, capacity_factor)
    x2d = x.reshape(-1, tcfg.d_model)
    e, k = tcfg.n_experts, tcfg.top_k
    capacity = max(1, int(capacity_factor * x2d.shape[0] * k / e))
    jbuf, jmeta = jax_moe._dispatch(jnp.asarray(x2d), jnp.asarray(jp["router"]), e, k,
                                    capacity)
    with torch.no_grad():
        buf, meta = moe._dispatch(torch.from_numpy(x2d), p.router, e, k, capacity)
    for name, got, want in zip(("experts", "ranks", "keep"), meta[:3], jmeta[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert meta[4] == jmeta[5] == x2d.shape[0]
    np.testing.assert_allclose(meta[3].numpy(), np.asarray(jmeta[3]), rtol=ACT_TOL)
    assert buf.shape == (e, capacity, tcfg.d_model) and buf.dtype == torch.float32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    if capacity_factor < 1.0:        # fewer slots than assignments
        assert not meta[2].all()


@pytest.mark.parametrize("arch,capacity_factor", CASES)
def test_moe_apply_local_matches_jax(arch, capacity_factor):
    jcfg, jp, tcfg, p, x = _pair(arch, capacity_factor)
    want = jax.jit(lambda p, x: jax_moe.moe_apply_local(p, jcfg, x))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        got = moe.moe_apply_local(p, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACT_TOL, rtol=ACT_TOL)


@pytest.mark.parametrize("arch,capacity_factor",
                         [("mixtral", 0.5), ("llama4", 0.5), ("gpt-moe", 0.5)])
def test_moe_gradients_match_jax_with_drops(arch, capacity_factor):
    """Gradients of every weight (the router's too) and of the tokens, with
    dropped assignments, against JAX's.  Top-1 routing renormalises the one
    weight to 1, so no gradient reaches the router: there both sides must
    be zero up to rounding, measured against the largest gradient."""
    jcfg, jp, tcfg, p, x = _pair(arch, capacity_factor)
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jax_moe.moe_apply_local(params, jcfg, x) * g)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, jp),
                                                        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    names, params = zip(*p.named_parameters())
    loss = torch.sum(moe.moe_apply_local(p, tcfg, tx) * torch.from_numpy(g))
    grads = torch.autograd.grad(loss, (*params, tx))
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jgp)[0]}
    assert sorted(names) == sorted(flat)
    wants = [np.asarray(w) for w in (*(flat[n] for n in names), jgx)]
    top = max(np.abs(w).max() for w in wants)
    for name, got, want in zip((*names, "x"), grads, wants):
        if name == "router" and tcfg.top_k == 1:
            assert max(np.abs(got.numpy()).max(), np.abs(want).max()) <= GRAD_TOL * top
            continue
        err = np.abs(got.numpy() - want).max()
        assert err <= GRAD_TOL * max(1e-3, np.abs(want).max()), (name, err)


def test_bf16_keeps_repro_dtypes():
    """bf16 experts: the buffer and the output in x's dtype, the router in
    float32; values within the bf16 tolerance of JAX's."""
    jcfg, jp, tcfg, p, x = _pair("llama4", 1.25, dtype=jnp.bfloat16)
    assert p.router.dtype == torch.float32 and p.w_up.dtype == torch.bfloat16
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jax.jit(lambda p, x: jax_moe.moe_apply_local(p, jcfg, x))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        buf, _ = moe._dispatch(xb.reshape(-1, tcfg.d_model), p.router, 4, 1, 15)
        got = moe.moe_apply_local(p, tcfg, xb)
    assert buf.dtype == torch.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_like_lax(k):
    rows = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                       [0.3, 0.1, 0.3, 0.3], [0.0, 0.5, 0.0, 0.5]], np.float32)
    vals, idx = moe.top_k(torch.from_numpy(rows), k)
    jvals, jidx = lax.top_k(jnp.asarray(rows), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_telemetry_counts_dropped_assignments():
    _, _, tcfg, p, x = _pair("mixtral", 0.5)
    x2d = torch.from_numpy(x.reshape(-1, tcfg.d_model))
    capacity = max(1, int(0.5 * x2d.shape[0] * 2 / 4))
    keep = moe._dispatch(x2d, p.router, 4, 2, capacity)[1][2]
    obs.enable()
    obs.reset()
    try:
        with torch.no_grad():
            moe.moe_apply_local(p, tcfg, torch.from_numpy(x))
        counters = obs.summary()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert counters["moe.assignments"] == x2d.shape[0] * 2
    assert counters["moe.dropped_assignments"] == int((~keep).sum()) > 0


def test_held_counter_sums_in_place_and_is_read_by_the_summary():
    from repro_torch.obs import Telemetry
    tel = Telemetry().enable()
    for n in (3, 4):
        tel.count_held("drops", torch.tensor(n))
    assert tel.counters == {}                    # nothing read yet
    held = tel._held["drops"]
    tel.count_held("drops", torch.tensor(5))
    assert tel._held["drops"] is held and int(held) == 12
    assert tel.summary()["counters"] == {"drops": 12}
    tel.count_held("drops", torch.tensor(1))
    assert [e["args"]["drops"] for e in tel.chrome_trace()["traceEvents"]
            if e["name"] == "drops"] == [12, 13]
    tel.count_held("drops", torch.tensor(1))
    tel.reset()
    assert tel.summary()["counters"] == {}
    tel.disable().count_held("drops", torch.tensor(1))
    assert tel._held == {}


@pytest.mark.parametrize("kw", [{"tp": 2}, {"moe_impl": "ep"}, {"moe_impl": "ep", "tp": 4},
                                {"moe_impl": "ep", "tp": 4, "group": Axis("model", (0, 1), 0)}])
def test_sharded_experts_need_the_model_axis_group(kw):
    """Sharded experts (tp > 1) run on the model axis: without its process
    group of tp ranks the call raises a ValueError that names the group
    (tests/test_torch_parallel.py holds tp > 1 to repro).  ``moe_impl="ep"``
    on one device is not sharded: ``repro`` runs its local capacity path
    there, and so must the port, with JAX's values."""
    jcfg, jp, tcfg, p, x = _pair("mixtral", 1.25)
    if kw.get("tp", 1) != 1:
        with pytest.raises(ValueError, match="process group of 4 ranks|process group of 2 ranks"):
            moe.moe_apply_local(p, tcfg, torch.from_numpy(x), **kw)
        return
    want = jax.jit(lambda p, x: jax_moe.moe_apply_local(p, jcfg, x, tp=1, **kw))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        got = moe.moe_apply_local(p, tcfg, torch.from_numpy(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACT_TOL, rtol=ACT_TOL)


# ------------------------------------------------------------ ep over a model axis

ROOT = Path(__file__).resolve().parents[1]
SHARED_CF = 4.0            # E / top_k of reduced Llama-4: no assignment drops
SHARED_CASES = [{"tp": 1}, {"tp": 2}, {"tp": 2, "a2a_impl": "xla"}]
# (tokens a data shard, capacity factor) of the routed-part cases at tp = 4:
# 7 tokens leave 3 without a routed expert, 3 give every rank an empty slice
SLICE_CASES = {"t7": (7, 1.25), "t3": (3, 1.25)}


def _shard_map_moe(jcfg, jp, x, mesh_shape, impl, tp):
    """repro's MoE body in shard_map over ``mesh_shape`` (data, model), the
    tokens split over data, the weights as ``_moe_dispatch`` splits them."""
    from jax.sharding import PartitionSpec as P
    from repro.parallel.compat import shard_map

    mesh = jax.make_mesh(mesh_shape, ("data", "model"))
    ax = "model" if impl == "ep" else None
    wspec = {"router": P(None, None)}
    for name in ("w_up", "w_gate", "w_down"):
        if name in jp:
            wspec[name] = (P(ax, None, None) if impl == "ep" else
                           P(None, "model", None) if name == "w_down" else
                           P(None, None, "model"))
    if "shared" in jp:
        wspec["shared"] = {n: P("model", None) if n == "w_down" else P(None, "model")
                           for n in jp["shared"]}
    body = functools.partial(jax_moe.moe_apply_local, cfg=jcfg, axis_name="model",
                             moe_impl=impl, tp=tp)
    y = jax.jit(shard_map(lambda pl, xl: body(pl, x=xl), mesh=mesh,
                          in_specs=(wspec, P("data", None, None)),
                          out_specs=P("data", None, None), check_vma=False))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    return np.asarray(y)


def _world_refs():
    """repro's outputs for the world's checks: Llama-4 in tp mode at (2, 2)
    and Mixtral in ep mode at (1, 4) on the slice cases."""
    jcfg, jp, _, _, x = _pair("llama4", SHARED_CF)
    refs = {"shared_jax_tp": _shard_map_moe(jcfg, jp, x, (2, 2), "tp", 2)}
    for key, (t, cf) in SLICE_CASES.items():
        jcfg, jp, _, _, x = _pair("mixtral", cf)
        xs = x.reshape(-1, x.shape[-1])[:t][None]
        refs[f"{key}_x"] = xs
        try:
            refs[f"{key}_jax_ep"] = _shard_map_moe(jcfg, jp, xs, (1, 4), "ep", 4)
        except Exception as e:   # recorded: the test names it
            refs[f"{key}_jax_ep_error"] = f"{type(e).__name__}: {e}"[:300]
    return refs


def _moe_holder(p):
    holder = torch.nn.Module()
    holder.moe = p
    return holder


def _rank(rank, refs):
    from repro_torch.convert import shard_params
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import make_mesh, mesh_axis

    torch.set_num_threads(1)
    out = {}
    # Llama-4's shared expert at (2, 2): each data shard one row of x
    _, _, tcfg, p, x = _pair("llama4", SHARED_CF)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    ax, d = mesh_axis(mesh, "model"), mesh_axis(mesh, "data").index
    xd = torch.from_numpy(x[d:d + 1].copy())
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(xd.shape).astype(np.float32))
    xr = xd.clone().requires_grad_()
    want = moe.moe_apply_local(p, tcfg, xr)
    (want * g).sum().backward()
    with sharding.parallel_rules(sharding.mesh_axes(), mesh):
        local = shard_params(_moe_holder(p), mesh, moe_impl="ep").moe
        for a2a in ("binary", "xla"):
            xe = xd.clone().requires_grad_()
            got = moe.moe_apply_local(local, tcfg, xe, moe_impl="ep", a2a_impl=a2a, tp=2,
                                      group=ax)
            (got * g).sum().backward()
            out[f"shared_{a2a}_vs_unsharded"] = _rel(got.detach(), want.detach())
            out[f"shared_{a2a}_vs_jax_tp"] = _rel(got.detach(), refs["shared_jax_tp"][d:d + 1])
            out[f"shared_{a2a}_grad_x"] = _rel(xe.grad, xr.grad)
    # the routed part at (1, 4) with t % tp != 0 and t < tp (Mixtral)
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    ax = mesh_axis(mesh, "model")
    for key, (t, cf) in SLICE_CASES.items():
        _, _, tcfg, p, _ = _pair("mixtral", cf)
        xs = torch.from_numpy(refs[f"{key}_x"].copy()).requires_grad_()
        with sharding.parallel_rules(sharding.mesh_axes(), mesh):
            local = shard_params(_moe_holder(p), mesh, moe_impl="ep").moe
            got = moe.moe_apply_local(local, tcfg, xs, moe_impl="ep", tp=4, group=ax)
            got.sum().backward()
        yt = got.detach().numpy()
        out[f"{key}_routed_rows"] = int(np.abs(yt).reshape(t, -1).max(-1).astype(bool).sum())
        out[f"{key}_grad_finite"] = bool(torch.isfinite(xs.grad).all())
        if f"{key}_jax_ep" in refs:
            out[f"{key}_vs_jax_ep"] = _rel(yt, refs[f"{key}_jax_ep"])
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _main():
    from repro_torch.parallel.mesh import spawn_world

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    torch.set_num_threads(1)
    refs = _world_refs()
    outs = spawn_world(_rank, 4, refs, backend="gloo", timeout_s=300)
    merged = {}
    for key in outs[0]:
        vals = [o[key] for o in outs]
        merged[key] = (all(vals) if isinstance(vals[0], bool) else
                       max(vals) if isinstance(vals[0], float) else vals)
    merged["jax_errors"] = {k: v for k, v in refs.items() if k.endswith("_error")}
    print(json.dumps(merged))


@functools.lru_cache(maxsize=None)
def _world() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, str(Path(__file__)), "world"], capture_output=True,
                         text=True, env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-8000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kw", SHARED_CASES)
def test_ep_mode_with_a_shared_expert_needs_one_model_rank(kw):
    """Llama-4's shared expert is split over ``ff`` on the model axis in
    ``ep`` mode too (``param_pspecs``, as ``repro``'s specs).  At ``tp =
    1`` the call runs ``repro``'s local path with JAX's values; at ``tp =
    2`` (mesh (2, 2), both exchanges) each rank adds its ``ff`` share over
    all tokens before the all-reduce, so the output and the tokens'
    gradient equal the unsharded port's, and the output equals ``repro``'s
    ``tp`` mode on the same weights: the capacity factor E / top_k drops no
    assignment in either mode.  (``repro``'s own ``ep`` body adds only the
    rank's share on the rank's token slice: ROADMAP.md § 3.)"""
    if kw["tp"] != 1:
        r = _world()
        a2a = kw.get("a2a_impl", "binary")
        assert r[f"shared_{a2a}_vs_unsharded"] <= ACT_TOL
        assert r[f"shared_{a2a}_vs_jax_tp"] <= ACT_TOL
        assert r[f"shared_{a2a}_grad_x"] <= GRAD_TOL
        return
    jcfg, jp, tcfg, p, x = _pair("llama4", 1.25)
    assert p.shared is not None
    want = jax.jit(lambda p, x: jax_moe.moe_apply_local(p, jcfg, x, moe_impl="ep", tp=1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        got = moe.moe_apply_local(p, tcfg, torch.from_numpy(x), moe_impl="ep", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACT_TOL, rtol=ACT_TOL)


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_ep_slices_tokens_as_repro(case):
    """``repro``'s ``ep`` body dispatches t // tp tokens a rank: with 7
    tokens over 4 ranks the last 3 get no routed expert, with 3 none does
    (every rank's slice is empty and the exchange carries empty buffers).
    The port keeps that slicing: its output equals ``repro``'s, rows past
    4 * (t // 4) are zero, and the backward runs."""
    r = _world()
    assert r["jax_errors"] == {}
    t = SLICE_CASES[case][0]
    assert r[f"{case}_vs_jax_ep"] <= ACT_TOL
    assert r[f"{case}_routed_rows"] == [4 * (t // 4)] * 4
    assert r[f"{case}_grad_finite"]


def test_ep_with_fewer_tokens_than_ranks_runs_on_meta_tensors():
    """The dry run's decode cells give an ep rank no token: the empty
    dispatch runs on ``meta`` tensors in a fake world of 4 ranks."""
    from repro_torch.convert import shard_params
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import fake_world, make_mesh, mesh_axis

    _, _, tcfg, p, _ = _pair("llama4", 1.25)
    with fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
        with sharding.parallel_rules(sharding.mesh_axes(), mesh):
            local = shard_params(_moe_holder(p), mesh, moe_impl="ep").moe.to("meta")
            x = torch.empty((3, 1, tcfg.d_model), device="meta")
            y = moe.moe_apply_local(local, tcfg, x, moe_impl="ep", tp=4,
                                    group=mesh_axis(mesh, "model"))
    assert y.device.type == "meta" and y.shape == x.shape and y.dtype == x.dtype


if __name__ == "__main__":
    if sys.argv[1:] == ["world"]:
        _main()
