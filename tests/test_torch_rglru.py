"""The port's RG-LRU block and RecurrentGemma against the JAX package's, on
the CPU.

Reduced RecurrentGemma-2B (pattern rglru, rglru, swa; d_model 64,
rnn_width 64, 4 query heads over 1 KV head of 16, window 32, GeGLU) at 3
layers (one stacked group) and at 5 (one group and two ``rest`` RG-LRU
layers), with weights made by ``repro``'s ``init_params`` (biases, the conv
bias and the norm scales replaced by seeded random values, so that every
parameter matters) and converted with ``params_from_jax``; a JAX grads tree
has the params' structure, so the same function maps it.  The port runs on
the CPU, where its kernel wrappers take the plain versions.  Sequences run
past the window, so the window cuts keys in training and the ring caches
wrap in decoding.

The port's ``lru_scan`` is a doubling scan with a hand-written backward,
``repro``'s ``_lru_scan`` a ``lax.associative_scan``: they sum in other
orders, so they agree to float32 rounding.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models.rglru import _lru_scan as jax_lru_scan
from repro.models.rglru import init_rglru_block as jax_init_rglru_block
from repro.models.rglru import rglru_block_apply as jax_rglru_block_apply
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_arch
from repro_torch.convert import _tensor, params_from_jax
from repro_torch.launch import train as train_cli
from repro_torch.models import decode_step, forward, init_cache, init_params, lm_loss
from repro_torch.models.rglru import (init_rglru_block, init_rglru_cache, lru_scan,
                                      rglru_block_apply)
from repro_torch.train import (OptConfig, TrainConfig, init_opt_state, make_train_step,
                               synthetic_batch)

# tests/test_kernels.py's tolerances: float32 on both sides agrees to ~1e-6
# relative, gradients to ~1e-5 of their largest entry; bf16 rounds each
# product, the conv and the stored state in bf16 on both sides, in places
# where one ulp of a cancelled sum can differ, so bf16 is held to 2e-2 of
# the largest entry.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 2e-5
# After Adam steps an entry moves by ~lr whatever its gradient's size (as
# in tests/test_torch_train.py): 1e-4 absolute at lr 3e-3.
PARAM_TOL = 1e-4


def _perturbed(num_layers, dtype=jnp.float32):
    jcfg = dataclasses.replace(jax_get_arch("recurrentgemma").reduced(), num_layers=num_layers)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    rng = np.random.default_rng(13)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", None)
        a = np.array(leaf, copy=True)     # own memory, no view of a JAX buffer
        if name in ("b_r", "b_i", "conv_b", "scale"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tcfg = dataclasses.replace(get_arch("recurrentgemma").reduced(), num_layers=num_layers)
    return jcfg, jax.tree_util.tree_map_with_path(perturb, params), tcfg


@pytest.fixture(scope="module", params=[3, 5], ids=["3 layers", "5 layers with rest"])
def pair(request):
    return _perturbed(request.param)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(tcfg, tree):
    return params_from_jax(tcfg, tree, device="cpu")


def _close(got, want, dname, err_msg="", of_largest=False):
    """float32 elementwise at TOL; bf16, or with ``of_largest``, within TOL
    of the largest entry."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    if dname == "float32" and not of_largest:
        np.testing.assert_allclose(got, want, atol=TOL[dname], rtol=TOL[dname],
                                   err_msg=err_msg)
    else:
        err = np.abs(got - want).max()
        assert err <= TOL[dname] * max(1.0, np.abs(want).max()), (err_msg, err)


def test_configs_agree_and_resolve_by_name_and_alias():
    full_j, full_t = jax_get_arch("recurrentgemma"), get_arch("recurrentgemma")
    assert get_arch("recurrentgemma-2b") is full_t
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert full_t.param_count() == full_j.param_count()
    assert (full_t.num_layers, full_t.d_model, full_t.n_heads, full_t.n_kv_heads,
            full_t.head_dim, full_t.window, full_t.rnn_width, full_t.conv_width,
            full_t.layer_pattern) == (26, 2560, 10, 1, 256, 2048, 2560, 4,
                                      ("rglru", "rglru", "swa"))


@pytest.mark.parametrize("carry", [False, True], ids=["h0 None", "carry-in h0"])
def test_lru_scan_and_its_gradient_match_jax(carry):
    """Forward and every input's gradient against ``jax.vjp`` of
    ``_lru_scan``, over a sequence that is not a power of two."""
    rng = np.random.default_rng(0)
    b, s, w = 2, 75, 16
    a = rng.uniform(0.3, 1.0, (b, s, w)).astype(np.float32)
    bx = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    dlast = rng.standard_normal((b, w)).astype(np.float32)
    inputs = (a, bx, h0) if carry else (a, bx)

    def jfn(*xs):
        return jax_lru_scan(xs[0], xs[1], xs[2] if carry else None)

    (jh, jlast), vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    jgrads = vjp((jnp.asarray(dh), jnp.asarray(dlast)))
    tx = [torch.from_numpy(x).requires_grad_() for x in inputs]
    h, last = lru_scan(tx[0], tx[1], tx[2] if carry else None)
    grads = torch.autograd.grad((h, last), tx, (torch.from_numpy(dh), torch.from_numpy(dlast)))
    _close(h.detach(), jh, "float32")
    _close(last.detach(), jlast, "float32")
    for name, g, jg in zip(("da", "dbx", "dh0"), grads, jgrads):
        err = np.abs(g.numpy() - np.asarray(jg)).max()
        assert err <= GRAD_TOL * np.abs(np.asarray(jg)).max(), (name, err)


def _block(dname, seed=0):
    """(jcfg, JAX block params, port block params) from one JAX init, the
    biases made random."""
    jcfg = jax_get_arch("recurrentgemma").reduced()
    p = jax_init_rglru_block(jax.random.PRNGKey(seed), jcfg, getattr(jnp, dname))
    rng = np.random.default_rng(seed + 1)
    p = {k: np.array(v, copy=True) for k, v in p.items()}
    for k in ("b_r", "b_i", "conv_b"):
        p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(p[k].dtype)
    return jcfg, p, {k: _tensor(v, "cpu") for k, v in p.items()}


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_rglru_block_apply_matches_jax(dname):
    jcfg, jp, tp = _block(dname)
    x = np.random.default_rng(2).standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jax_rglru_block_apply(p, jcfg, x))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x).astype(getattr(jnp, dname)))
    with torch.no_grad():
        got, cache = rglru_block_apply(tp, get_arch("recurrentgemma").reduced(),
                                       torch.from_numpy(x).to(getattr(torch, dname)))
    assert cache is None and got.dtype == getattr(torch, dname) and got.shape == x.shape
    _close(got.float(), want, dname)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_rglru_decode_matches_jax_and_stores_the_state_in_the_activations_dtype(dname):
    """Eight one-token steps from a zero cache: outputs, ``h`` and the conv
    cache against JAX's.  A bf16 decode stores the float32 update of ``h``
    in bf16 every token, as ``repro`` does, and the next step reads it
    back: the states agree token after token."""
    jcfg, jp, tp = _block(dname, seed=3)
    tcfg = get_arch("recurrentgemma").reduced()
    dt, jdt = getattr(torch, dname), getattr(jnp, dname)
    x = np.random.default_rng(4).standard_normal((3, 8, jcfg.d_model)).astype(np.float32)
    jcache = {"h": jnp.zeros((3, 64), jdt), "conv": jnp.zeros((3, 3, 64), jdt)}
    tcache = init_rglru_cache(tcfg, 3, dt, "cpu")
    jstep = jax.jit(lambda p, c, x: jax_rglru_block_apply(p, jcfg, x, c, decode=True))
    jparams = jax.tree.map(jnp.asarray, jp)
    for t in range(8):
        jy, jcache = jstep(jparams, jcache, jnp.asarray(x[:, t:t + 1]).astype(jdt))
        with torch.no_grad():
            y, new = rglru_block_apply(tp, tcfg, torch.from_numpy(x[:, t:t + 1]).to(dt),
                                       tcache, decode=True)
        tcache = new
        assert new["h"].dtype == dt and new["conv"].dtype == dt and y.dtype == dt
        assert jcache["h"].dtype == jdt
        assert new["h"].shape == (3, 64) and new["conv"].shape == (3, 3, 64)
        _close(y.float(), jy, dname, f"y step {t}")
        _close(new["h"].float(), jcache["h"], dname, f"h step {t}")
        _close(new["conv"].float(), jcache["conv"], dname, f"conv step {t}")


LAYOUT = {3: ["rglru", "rglru", "swa"], 5: ["rglru", "rglru", "swa", "rglru", "rglru"]}


@pytest.mark.parametrize("num_layers", [3, 5])
def test_init_params_builds_repro_layers(num_layers):
    """The port's own weights have the layer kinds, parameter names, shapes
    and dtypes of the JAX package's (``b_r``, ``b_i``, ``lam`` and the norms
    float32), and ``lam`` is the reference's closed form."""
    tcfg = dataclasses.replace(get_arch("recurrentgemma").reduced(), num_layers=num_layers)
    jcfg = dataclasses.replace(jax_get_arch("recurrentgemma").reduced(), num_layers=num_layers)
    model = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [layer.kind for layer in model.layers] == LAYOUT[num_layers]
    tree = jax_init_params(jcfg, jax.random.PRNGKey(0))
    assert len(tree["rest"]) == (2 if num_layers == 5 else 0)
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, tree),
                                device="cpu").named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert (p.shape, p.dtype) == (want[name].shape, want[name].dtype), name
    f32 = [n for n, p in got.items() if ".rglru." in n and p.dtype == torch.float32]
    assert sorted({n.rsplit(".", 1)[1] for n in f32}) == ["b_i", "b_r", "lam"]
    for name in (n for n in got if n.endswith(".lam")):
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].detach().numpy(),
                                   atol=TOL["float32"], rtol=TOL["float32"], err_msg=name)
    # the port's own init draws the same block from one generator as init_rglru_block
    block = init_rglru_block(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in block.items()} == {
        k.rsplit(".", 1)[1]: (p.shape, p.dtype) for k, p in got.items()
        if k.startswith("layers.0.rglru.")}


@pytest.fixture(scope="module")
def jax_ref(pair):
    """The JAX hidden states, loss and gradients of one batch past the
    window, in one jitted call."""
    jcfg, tree, tcfg = pair
    batch = synthetic_batch(tcfg, 0, 2, 72)

    def loss_and_hidden(p, b):
        h = jax_forward(p, jcfg, b)
        return jax_lm_loss(p, jcfg, h, b["labels"]), h

    (jloss, jh), jgrads = jax.jit(jax.value_and_grad(loss_and_hidden, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _jbatch(batch))
    return batch, np.asarray(jh), float(jloss), jax.tree.map(np.asarray, jgrads)


def test_forward_and_loss_match_jax(pair, jax_ref):
    _, tree, tcfg = pair
    batch, jh, jloss, _ = jax_ref
    model = _model(tcfg, tree)
    with torch.no_grad():
        h = forward(model, _tbatch(batch))
        loss = lm_loss(model, h, torch.from_numpy(batch["labels"]))
    assert h.shape == (2, 72, tcfg.d_model) and h.dtype == torch.float32
    # the scans' float32 rounding passes through up to 4 RG-LRU layers and the
    # final norm, so the hidden states are held to TOL of their largest entry
    _close(h, jh, "float32", of_largest=True)
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL["float32"])


@pytest.mark.parametrize("remat", [True, False])
def test_every_gradient_leaf_matches_jax(pair, jax_ref, remat):
    _, tree, tcfg = pair
    batch, _, jloss, jgrads = jax_ref
    model = _model(tcfg, tree)
    names, params = zip(*model.named_parameters())
    tb = _tbatch(batch)
    loss = lm_loss(model, forward(model, tb, remat=remat), tb["labels"])
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = dict(params_from_jax(tcfg, jgrads, device="cpu").named_parameters())
    assert sorted(grads) == sorted(want)
    # embed, final norm; per RG-LRU layer norm1, 10 block leaves, norm2, 3 MLP
    # leaves; per attention layer norm1, 4 projections, norm2, 3 MLP leaves
    n_rglru = sum(k == "rglru" for k in LAYOUT[tcfg.num_layers])
    assert len(grads) == 2 + 15 * n_rglru + 9 * (tcfg.num_layers - n_rglru)
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL["float32"])
    for name, g in grads.items():
        w = want[name].detach().numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * max(1e-3, np.abs(w).max()), (name, err)


def test_three_train_steps_match_jax(pair):
    jcfg, tree, tcfg = pair
    jopt = JaxOptConfig(lr=3e-3, warmup_steps=2)
    topt = OptConfig(lr=3e-3, warmup_steps=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jax_init_opt_state(jparams, jopt)}
    model = _model(tcfg, tree)
    state = {"params": model, "opt": init_opt_state(model, topt)}
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(opt=jopt)))
    step = make_train_step(tcfg, TrainConfig(opt=topt))
    for i in range(3):
        batch = synthetic_batch(tcfg, i, 2, 64)
        jstate, jm = jstep(jstate, _jbatch(batch))
        state, m = step(state, _tbatch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL["float32"])
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_TOL)
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jstate["params"]),
                                device="cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


def _jax_layer_caches(jcache, num_layers):
    """JAX's per-layer caches in layer order: stacked group slots, then rest."""
    groups, rest = jcache["groups"], jcache["rest"]
    cycle = len(groups)
    n_groups = len(next(iter(groups[0].values())))
    out = {g * cycle + s: {k: v[g] for k, v in slot.items()}
           for s, slot in enumerate(groups) for g in range(n_groups)}
    out.update({n_groups * cycle + j: c for j, c in enumerate(rest)})
    return [out[i] for i in range(num_layers)]


def test_decode_steps_match_jax(pair):
    """48 lockstep steps of 3 lanes, past the window of 32 and around the
    32-slot ring of the swa layer: next tokens equal, every RG-LRU layer's
    ``h`` and conv cache within float32 rounding of JAX's."""
    jcfg, tree, tcfg = pair
    jparams = jax.tree.map(jnp.asarray, tree)
    model = _model(tcfg, tree)
    b, max_len = 3, 64
    jcache = jax_init_cache(jparams, jcfg, b, max_len, dtype=jnp.float32)
    tcache = init_cache(model, b, max_len, dtype=torch.float32)
    assert [sorted(c) for c in tcache] == [
        ["k", "pos", "v"] if k == "swa" else ["conv", "h"] for k in LAYOUT[tcfg.num_layers]]
    assert [c["k"].shape[1] for c in tcache if "k" in c] == [32] * (tcfg.num_layers // 3)
    jstep = jax.jit(lambda c, t, pos: jax_decode_step(jparams, jcfg, c, t, pos))
    rng = np.random.default_rng(3)
    for i in range(48):
        tokens = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        positions = np.full((b,), i, np.int32)
        jnext, jcache = jstep(jcache, jnp.asarray(tokens), jnp.asarray(positions))
        tnext, tcache = decode_step(model, tcache, tokens, positions)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext), err_msg=f"step {i}")
    for li, (c, jc) in enumerate(zip(tcache, _jax_layer_caches(jcache, tcfg.num_layers))):
        for key in ("h", "conv") if "h" in c else ():
            assert c[key].dtype == torch.float32
            _close(c[key], jc[key], "float32", f"layer {li} {key}")


def test_lockstep_decode_equals_forward_greedy():
    """Greedy decode over the RG-LRU states and the swa ring == the parallel
    forward's predictions past the window, as tests/test_models.py checks
    for JAX."""
    cfg = dataclasses.replace(get_arch("recurrentgemma").reduced(), num_layers=5)
    model = init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.float32)
    b, s = 2, 48
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s)))
    with torch.no_grad():
        h = forward(model, {"tokens": toks}, remat=False)
        pred_fwd = torch.argmax((h @ model.embed.T)[..., :cfg.vocab_size], dim=-1)
    cache = init_cache(model, b, max_len=s, dtype=torch.float32)
    preds = []
    for i in range(s):
        nxt, cache = decode_step(model, cache, toks[:, i:i + 1].numpy(), np.full((b,), i))
        preds.append(nxt)
    assert torch.equal(torch.stack(preds, 1).long(), pred_fwd)


def test_cli_trains_recurrentgemma_on_the_cpu(capsys):
    train_cli.main(["--arch", "recurrentgemma", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "40"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "recurrentgemma-2b-reduced" and out["steps"] == 3
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
