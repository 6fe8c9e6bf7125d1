"""The port's decoder-only attention configs against the JAX package's, on
the CPU: sliding-window (H2O-Danube, Mixtral) and chunked (Llama-4
Maverick) attention, dense MLPs (Qwen2.5 with QKV bias, DeepSeek) and MoE
MLPs (Mixtral, Llama-4 with a shared expert, GPT-MoE with GELU experts).

Each reduced config (window 32, d_model 64, 4 experts) gets float32 weights
from ``repro``'s ``init_params`` (biases and norm scales replaced by seeded
random values, so that every parameter matters), converted with
``params_from_jax``; a JAX grads tree has the params' structure, so the
same function maps it.  The port runs on the CPU, where its kernel wrappers
take the plain versions.  Sequences run past the window, so the window and
chunk masks cut keys in training and the ring caches wrap in decoding.
"""

import dataclasses

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
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step, forward, init_cache, init_params, lm_loss
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, init_opt_state, make_train_step,
                               synthetic_batch)

# float32 on both sides, as tests/test_torch_train.py: activations and the
# loss agree to ~1e-6 relative, gradients to ~1e-5 of their largest entry,
# and 3 Adam steps move each weight by ~lr whatever its gradient's size.
ACT_TOL = 2e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-4
# Adam's eps in the train-step comparison.  At rope_theta 1e6 (Qwen2.5) a
# key bias shifts a query's logits almost alike in the lowest RoPE
# frequencies, so those entries of its gradient are ~1e-8, where float32
# sums in another order differ by tens of percent; at the default eps of
# 1e-8 Adam would turn that into moves of a sizeable share of lr.
ADAM_EPS = 1e-6

ARCHS = ["h2o-danube", "mixtral", "llama4", "qwen", "deepseek", "gpt-moe"]
# the kind and the MLP of each layer of the reduced configs
LAYOUT = {
    "h2o-danube": ["swa dense"] * 2,
    "mixtral": ["swa moe"] * 2,
    "llama4": ["chunked dense", "chunked moe+shared", "chunked dense", "attn moe+shared"],
    "qwen": ["attn dense"] * 2,
    "deepseek": ["attn dense"] * 2,
    "gpt-moe": ["attn dense", "attn moe"],
}


def _perturbed(arch):
    jcfg = jax_get_arch(arch).reduced()
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", None)
        a = np.array(leaf, copy=True)     # own memory, no view of a JAX buffer
        if name in ("bq", "bk", "bv", "bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "scale":
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jcfg, jax.tree_util.tree_map_with_path(perturb, params), get_arch(arch).reduced()


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _perturbed(request.param)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(tcfg, tree):
    return params_from_jax(tcfg, tree, device="cpu")


def _layout(model):
    out = []
    for layer in model.layers:
        mlp = ("moe+shared" if layer.moe.shared is not None else "moe") \
            if layer.moe is not None else "dense"
        out.append(f"{layer.kind} {mlp}")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_and_resolve_by_name_and_alias(arch):
    full_j, full_t = jax_get_arch(arch), get_arch(arch)
    assert get_arch(full_t.name) is full_t
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert full_t.param_count() == full_j.param_count()
    assert full_t.active_param_count() == full_j.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_builds_repro_layers(arch):
    """The port's own weights have the layer kinds, MLPs, parameter names,
    shapes and dtypes of the JAX package's (the router float32)."""
    tcfg = get_arch(arch).reduced()
    model = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert _layout(model) == LAYOUT[arch]
    tree = jax_init_params(jax_get_arch(arch).reduced(), jax.random.PRNGKey(0))
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, tree),
                                device="cpu").named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert (p.shape, p.dtype) == (want[name].shape, want[name].dtype), name
    if tcfg.n_experts:
        assert all(p.dtype == torch.float32 for n, p in got.items() if n.endswith("router"))


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
    np.testing.assert_allclose(h.numpy(), jh, atol=ACT_TOL, rtol=ACT_TOL)
    np.testing.assert_allclose(loss.item(), jloss, rtol=ACT_TOL)


def test_every_gradient_leaf_matches_jax(pair, jax_ref):
    _, tree, tcfg = pair
    batch, _, jloss, jgrads = jax_ref
    model = _model(tcfg, tree)
    names, params = zip(*model.named_parameters())
    tb = _tbatch(batch)
    loss = lm_loss(model, forward(model, tb), tb["labels"])
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = dict(params_from_jax(tcfg, jgrads, device="cpu").named_parameters())
    assert sorted(grads) == sorted(want)
    if tcfg.n_experts:
        assert any(n.endswith("moe.router") for n in grads)
    np.testing.assert_allclose(loss.item(), jloss, rtol=ACT_TOL)
    for name, g in grads.items():
        w = want[name].detach().numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * max(1e-3, np.abs(w).max()), (name, err)


def test_three_train_steps_match_jax(pair):
    jcfg, tree, tcfg = pair
    jopt = JaxOptConfig(lr=3e-3, warmup_steps=2, eps=ADAM_EPS)
    topt = OptConfig(lr=3e-3, warmup_steps=2, eps=ADAM_EPS)
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
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=ACT_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_TOL)
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jstate["params"]),
                                device="cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


def test_decode_steps_match_jax(pair):
    """Lane 0 runs to 46, past the window and past the 32-slot ring of the
    windowed layers (the full-attention ring has 48); lane 1 restarts at 0
    after 30 steps; lane 2 cycles through short sequences."""
    jcfg, tree, tcfg = pair
    jparams = jax.tree.map(jnp.asarray, tree)
    model = _model(tcfg, tree)
    b, max_len = 3, 48
    jcache = jax_init_cache(jparams, jcfg, b, max_len)
    tcache = init_cache(model, b, max_len)
    assert [c["k"].shape[1] for c in tcache] == [
        32 if tcfg.pattern_at(i) in ("swa", "chunked") else max_len
        for i in range(tcfg.num_layers)]
    jstep = jax.jit(lambda c, t, pos: jax_decode_step(jparams, jcfg, c, t, pos))
    rng = np.random.default_rng(3)
    for i in range(47):
        tokens = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        positions = np.asarray([i, i if i < 30 else i - 30, i % 7], np.int32)
        jnext, jcache = jstep(jcache, jnp.asarray(tokens), jnp.asarray(positions))
        tnext, tcache = decode_step(model, tcache, tokens, positions)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext), err_msg=f"step {i}")


def _awaited(jeng):
    """Wait for each JAX engine step (tests/test_torch_serve.py says why)."""
    step = jeng._step
    jeng._step = lambda *a: jax.block_until_ready(step(*a))
    return jeng


def _drive(engine, request_cls, vocab):
    """4 requests through 3 slots: prompts past the window, a reused slot,
    and idle lanes that still pass through MoE routers."""
    rng = np.random.default_rng(5)
    reqs = [request_cls(i, rng.integers(0, vocab, n).tolist(), max_new=m)
            for i, (n, m) in enumerate([(40, 6), (3, 9), (35, 4), (45, 5)])]
    log = [engine.submit(reqs[0]), engine.submit(reqs[1])]
    log.append(engine.step())
    log.append(engine.submit(reqs[2]))
    log.append(len(engine.run_until_done()))
    log.append(engine.submit(reqs[3]))
    log.append(len(engine.run_until_done()))
    return [r.out for r in reqs], log


def test_serve_engine_streams_match_jax(pair):
    jcfg, tree, tcfg = pair
    jeng = _awaited(JaxServeEngine(jcfg, jax.tree.map(jnp.asarray, tree), max_batch=3,
                                   max_len=64))
    jstreams, jlog = _drive(jeng, JaxRequest, jcfg.vocab_size)
    tstreams, tlog = _drive(ServeEngine(tcfg, _model(tcfg, tree), max_batch=3, max_len=64,
                                        device="cpu"), Request, tcfg.vocab_size)
    assert tlog == jlog
    assert tstreams == jstreams
    assert [len(s) for s in tstreams] == [6, 9, 4, 5]


@pytest.mark.parametrize("arch", ["h2o-danube", "llama4"])
def test_window_and_chunk_change_the_output(arch):
    """The masks are live at S = 72: widening the window to the whole
    sequence changes every row past it."""
    cfg = get_arch(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu",
                        dtype=torch.float32)
    toks = {"tokens": torch.from_numpy(synthetic_batch(cfg, 0, 1, 72)["tokens"])}
    with torch.no_grad():
        h = forward(model, toks)
        model.cfg = dataclasses.replace(cfg, window=128)
        wide = forward(model, toks)
    assert torch.equal(h[:, :32], wide[:, :32])
    assert not torch.allclose(h[:, 33:], wide[:, 33:])
