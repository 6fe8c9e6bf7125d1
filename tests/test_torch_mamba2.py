"""The port's Mamba-2 slice against the JAX package's, on the CPU.

Reduced Mamba2-780m (2 SSD layers, d_model 64, 8 heads of P = 16, N = 16,
chunk 8) with weights made by ``repro``'s ``init_params`` (biases, D,
dt_bias and the norm scales replaced by seeded random values, so that every
parameter matters) and converted with ``params_from_jax``; a JAX grads tree
has the params' structure, so the same function maps it.  The port runs on
the CPU, where its SSD-scan wrapper takes the plain versions.
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
from repro.models.ssm import ssd_block_apply as jax_ssd_block_apply
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import loss_fn as jax_loss_fn
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_cli
from repro_torch.models import decode_step, forward, init_cache, init_params, lm_loss
from repro_torch.models.ssm import ssd_block_apply
from repro_torch.train import (OptConfig, TrainConfig, init_opt_state, make_train_step,
                               synthetic_batch)

# float32 on both sides; sums run in another order, so activations and the
# loss agree to ~1e-6 relative and gradients to ~1e-5 of their largest
# entry.  bf16 weights round each product and the conv in bf16 in both, in
# places that differ (torch's SiLU rounds once, JAX's per operation).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 2e-5
# After Adam steps an entry moves by ~lr whatever its gradient's size (as
# in tests/test_torch_train.py): 1e-4 absolute at lr 3e-3.
PARAM_TOL = 1e-4


def _perturbed(dtype=jnp.float32):
    jcfg = jax_get_arch("mamba2").reduced()
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    rng = np.random.default_rng(12)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", None)
        a = np.array(leaf, copy=True)     # own memory, no view of a JAX buffer
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name in ("conv_x_b", "conv_B_b", "conv_C_b", "dt_bias"):
            return (0.1 * noise).astype(a.dtype)
        if name in ("scale", "norm_scale"):
            return (0.1 * noise).astype(a.dtype)
        if name == "D":
            return (1.0 + 0.1 * noise).astype(a.dtype)
        return a

    return jcfg, jax.tree_util.tree_map_with_path(perturb, params), get_arch("mamba2").reduced()


@pytest.fixture(scope="module")
def pair():
    return _perturbed()


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(tcfg, tree):
    return params_from_jax(tcfg, tree, device="cpu")


def test_configs_agree():
    for name in ("mamba2", "mamba2-780m"):
        full_j, full_t = jax_get_arch(name), get_arch(name)
        assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
        assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    cfg = get_arch("mamba2").reduced()
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk, cfg.d_ff) == (2, 64, 8, 16, 16, 8, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_block_apply_matches_jax(dtype):
    jcfg, tree, tcfg = _perturbed(getattr(jnp, dtype))
    p = jax.tree.map(lambda v: v[0], tree["groups"][0]["ssd"])
    layer = _model(tcfg, tree).layers[0]
    x = np.random.default_rng(2).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want, _ = jax.jit(lambda p, x: jax_ssd_block_apply(p, jcfg, x))(
        jax.tree.map(jnp.asarray, p), jx)
    with torch.no_grad():
        got, cache = ssd_block_apply(layer.ssd, tcfg, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert cache is None and got.dtype == getattr(torch, dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_forward_and_loss_match_jax(pair):
    jcfg, tree, tcfg = pair
    model = _model(tcfg, tree)
    batch = synthetic_batch(tcfg, 0, 3, 40)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh, jloss = jax.jit(lambda p, b: (jax_forward(p, jcfg, b), jax_lm_loss(
        p, jcfg, jax_forward(p, jcfg, b), b["labels"])))(jparams, _jbatch(batch))
    with torch.no_grad():
        h = forward(model, _tbatch(batch))
        loss = lm_loss(model, h, torch.from_numpy(batch["labels"]))
    assert h.shape == (3, 40, tcfg.d_model) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL["float32"],
                               rtol=TOL["float32"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL["float32"])


@pytest.mark.parametrize("remat", [True, False])
def test_every_gradient_leaf_matches_jax(pair, remat):
    jcfg, tree, tcfg = pair
    model = _model(tcfg, tree)
    batch = synthetic_batch(tcfg, 1, 2, 48)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, _jbatch(batch), JaxTrainConfig(remat=remat))))(
            jax.tree.map(jnp.asarray, tree))
    names, params = zip(*model.named_parameters())
    tb = _tbatch(batch)
    loss = lm_loss(model, forward(model, tb, remat=remat), tb["labels"])
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads),
                                device="cpu").named_parameters())
    # embed, final norm, and per layer norm1 plus the 16 SSD parameters
    assert sorted(grads) == sorted(want) and len(grads) == 2 + 2 * 17
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL["float32"])
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
        batch = synthetic_batch(tcfg, i, 4, 32)
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


def test_lockstep_decode_equals_forward_greedy():
    """Greedy decode over the SSD state == the parallel forward's
    predictions, as tests/test_models.py checks for JAX."""
    cfg = get_arch("mamba2").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.float32)
    b, s = 2, 16
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
    assert all(c["state"].dtype == torch.float32 for c in cache)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(pair, cache_dtype):
    jcfg, tree, tcfg = pair
    jparams = jax.tree.map(jnp.asarray, tree)
    model = _model(tcfg, tree)
    b, steps = 3, 6
    jcache = jax_init_cache(jparams, jcfg, b, 16, dtype=getattr(jnp, cache_dtype))
    tcache = init_cache(model, b, 16, dtype=getattr(torch, cache_dtype))
    rng = np.random.default_rng(3)
    jstep = jax.jit(lambda c, t, pos: jax_decode_step(jparams, jcfg, c, t, pos))
    for i in range(steps):
        tokens = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        positions = np.full((b,), i, np.int32)
        jnext, jcache = jstep(jcache, jnp.asarray(tokens), jnp.asarray(positions))
        tnext, tcache = decode_step(model, tcache, tokens, positions)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        assert not jcache["rest"] and len(jcache["groups"]) == 1
        for li, c in enumerate(tcache):
            assert c["state"].dtype == torch.float32
            for key in ("state", "conv_x", "conv_B", "conv_C"):
                want = np.asarray(jcache["groups"][0][key][li], np.float32)
                np.testing.assert_allclose(c[key].float().numpy(), want,
                                           atol=TOL["float32"], rtol=TOL["float32"],
                                           err_msg=f"layer {li} {key} step {i}")


def test_cli_trains_mamba2_on_the_cpu(capsys):
    train_cli.main(["--arch", "mamba2", "--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "mamba2-780m-reduced" and out["steps"] == 3
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
