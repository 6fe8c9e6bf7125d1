"""The port's training slice against the JAX package's, on the CPU.

Reduced StarCoder2 with float32 weights made by ``repro``'s ``init_params``
(biases and norm parameters replaced by seeded random values, so that every
parameter matters) and converted with ``params_from_jax``; a JAX grads tree
has the params' structure, so the same function maps it.  The port runs on
the CPU, where its flash-attention wrapper takes the plain versions.
"""

import dataclasses
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.train.data import synthetic_batch as jax_synthetic_batch
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import loss_fn as jax_loss_fn
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_cli
from repro_torch.models import forward, lm_loss
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import (OptConfig, TrainConfig, data_iter, init_opt_state,
                               init_train_state, make_train_step, synthetic_batch,
                               train_loop)

# float32 on both sides; sums run in another order (and JAX fuses), so
# activations and the loss agree to ~1e-6 relative, and gradients, which
# sum over the batch and sequence, to ~1e-5 of their largest entry.
ACT_TOL = 2e-5
GRAD_TOL = 2e-5
# After Adam steps the update of an entry is lr * m / (sqrt(v) + eps): it
# is ~lr for every entry whatever its gradient's size, so an entry whose
# gradient is tiny and differs in its last digits between frameworks may
# move by a visibly different amount.  1e-4 absolute at lr 3e-3.
PARAM_TOL = 1e-4


def _perturbed_pair():
    jcfg = jax_get_arch("starcoder2").reduced()
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", None)
        a = np.array(leaf, copy=True)     # own memory, no view of a JAX buffer
        if name in ("bq", "bk", "bv", "bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, params)
    return jcfg, tree, get_arch("starcoder2").reduced()


@pytest.fixture(scope="module")
def pair():
    return _perturbed_pair()


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(tcfg, tree):
    return params_from_jax(tcfg, tree, device="cpu")


def _assert_params_close(model, jtree, tcfg, tol):
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jtree),
                                device="cpu").named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   atol=tol, rtol=0, err_msg=name)


def test_forward_and_loss_match_jax(pair):
    jcfg, tree, tcfg = pair
    model = _model(tcfg, tree)
    batch = synthetic_batch(tcfg, 0, 3, 40)
    jh = jax_forward(jax.tree.map(jnp.asarray, tree), jcfg, _jbatch(batch))
    jloss = jax_lm_loss(jax.tree.map(jnp.asarray, tree), jcfg, jh,
                        jnp.asarray(batch["labels"]))
    with torch.no_grad():
        h = forward(model, _tbatch(batch))
        loss = lm_loss(model, h, torch.from_numpy(batch["labels"]))
    assert h.shape == (3, 40, tcfg.d_model) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ACT_TOL, rtol=ACT_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=ACT_TOL)


@pytest.mark.parametrize("remat", [True, False])
def test_every_gradient_leaf_matches_jax(pair, remat):
    jcfg, tree, tcfg = pair
    model = _model(tcfg, tree)
    batch = synthetic_batch(tcfg, 1, 2, 48)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, _jbatch(batch), JaxTrainConfig(remat=remat)))(
            jax.tree.map(jnp.asarray, tree))
    names, params = zip(*model.named_parameters())
    assert all(p.requires_grad for p in params)
    tb = _tbatch(batch)
    loss = lm_loss(model, forward(model, tb, remat=remat), tb["labels"])
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads),
                                device="cpu").named_parameters())
    assert sorted(grads) == sorted(want) and len(grads) == 2 * 13 + 3
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=ACT_TOL)
    for name, g in grads.items():
        w = want[name].detach().numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * max(1e-3, np.abs(w).max()), (name, err)


def _jax_opt_state(jparams, jopt):
    """``repro``'s optimizer state.  ``adamw_lowmem`` chooses between a
    factored and a plain second moment by the leaf's ndim, and JAX stacks
    the layers of a scan group, so it factors each per-layer vector (bias,
    norm scale) jointly across the layers.  The port factors per parameter,
    as the optimizer's docstring says (ROADMAP, faults); its update picks
    the plain path wherever the state holds ``"v"``, so the stacked vectors
    get a plain second moment here and both compute the same thing."""
    state = jax_init_opt_state(jparams, jopt)
    if jopt.name == "adamw_lowmem":
        state["v"]["groups"] = jax.tree.map(
            lambda p, v: {"v": jnp.zeros_like(p, jnp.float32)} if p.ndim == 2 else v,
            jparams["groups"], state["v"]["groups"],
            is_leaf=lambda x: isinstance(x, dict) and ("vr" in x or "v" in x))
    return state


@pytest.mark.parametrize("opt", ["adamw", "adamw_lowmem"])
def test_three_train_steps_match_jax(pair, opt):
    jcfg, tree, tcfg = pair
    jopt = JaxOptConfig(name=opt, lr=3e-3, warmup_steps=2)
    topt = OptConfig(name=opt, lr=3e-3, warmup_steps=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": _jax_opt_state(jparams, jopt)}
    model = _model(tcfg, tree)
    state = {"params": model, "opt": init_opt_state(model, topt)}
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(opt=jopt)))
    step = make_train_step(tcfg, TrainConfig(opt=topt))
    for i in range(3):
        batch = synthetic_batch(tcfg, i, 4, 32)
        jstate, jm = jstep(jstate, _jbatch(batch))
        state, m = step(state, _tbatch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=ACT_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_TOL)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-7)
    assert state["opt"]["step"] == 3
    _assert_params_close(model, jstate["params"], tcfg, PARAM_TOL)


def test_four_microbatches_equal_one_batch(pair):
    _, tree, tcfg = pair
    batch = _tbatch(synthetic_batch(tcfg, 0, 8, 33))
    out = []
    for mb in (1, 4):
        model = _model(tcfg, tree)
        tc = TrainConfig(microbatches=mb)
        state = {"params": model, "opt": init_opt_state(model, tc.opt)}
        state, m = make_train_step(tcfg, tc)(state, batch)
        out.append((m, dict(model.named_parameters())))
    (m1, p1), (m4, p4) = out
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=ACT_TOL)
    np.testing.assert_allclose(float(m4["grad_norm"]), float(m1["grad_norm"]),
                               rtol=GRAD_TOL)
    for name in p1:
        np.testing.assert_allclose(p4[name].detach().numpy(), p1[name].detach().numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("extra", [{}, {"prefix_len": 4}, {"enc_layers": 2, "enc_seq": 6}])
def test_synthetic_batch_bit_equal_to_jax(extra):
    jcfg = dataclasses.replace(jax_get_arch("starcoder2").reduced(), **extra)
    tcfg = dataclasses.replace(get_arch("starcoder2").reduced(), **extra)
    for step, seed in [(0, 0), (5, 1), (6, 1), (3, 7)]:
        a = jax_synthetic_batch(jcfg, step, 4, 32, seed=seed)
        b = synthetic_batch(tcfg, step, 4, 32, seed=seed)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    it = data_iter(tcfg, 2, 32, seed=3, start_step=4, device="cpu")
    for step in range(4, 7):
        a, b = jax_synthetic_batch(jcfg, step, 2, 32, seed=3), next(it)
        for k in a:
            assert b[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k], b[k].numpy())


def test_data_iter_raises_what_its_producer_raised():
    cfg = dataclasses.replace(get_arch("starcoder2").reduced(), prefix_len=4)
    with pytest.raises(ValueError, match="broadcast"):
        next(data_iter(cfg, 2, 16, device="cpu"))   # too short for a motif


def test_loss_decreases():
    cfg = get_arch("starcoder2").reduced()
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5))
    data = data_iter(cfg, batch=8, seq=64, device="cpu")
    _, hist = train_loop(cfg, tcfg, data, steps=25, log_every=0, device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)


def _state_tensors(state):
    return [(k, v) for k, v in ckpt._items(state)]


def test_checkpoint_roundtrip_and_resume_equal_uninterrupted_run():
    cfg = get_arch("starcoder2").reduced()
    tc = TrainConfig(opt=OptConfig(name="adamw_lowmem", lr=3e-3, warmup_steps=2))
    step_fn = make_train_step(cfg, tc)
    batches = [_tbatch(synthetic_batch(cfg, i, 2, 16)) for i in range(4)]
    whole = init_train_state(cfg, tc, 1, device="cpu")
    for b in batches:
        whole, _ = step_fn(whole, b)

    with tempfile.TemporaryDirectory() as d:
        state = init_train_state(cfg, tc, 1, device="cpu")
        for b in batches[:2]:
            state, _ = step_fn(state, b)
        path = ckpt.save(state, 2, d)
        assert ckpt.latest_step(d) == 2 and path.exists()
        with np.load(path) as data:
            assert "params/embed::bf16" in data and "opt/step" in data
            assert "opt/v/layers.0.attn.wq/vr" in data
        fresh = init_train_state(cfg, tc, 2, device="cpu")    # other weights
        restored = ckpt.restore(d, fresh)
        assert restored["opt"]["step"] == 2
        for (ka, a), (kb, b) in zip(_state_tensors(state), _state_tensors(restored)):
            assert ka == kb
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), ka
            else:
                assert a == b
        for b in batches[2:]:
            restored, _ = step_fn(restored, b)
    for (ka, a), (_, b) in zip(_state_tensors(whole), _state_tensors(restored)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), ka


def test_async_checkpoint_snapshots_before_training_goes_on():
    cfg = get_arch("starcoder2").reduced()
    state = init_train_state(cfg, TrainConfig(), 3, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        saver = ckpt.AsyncCheckpointer(d)
        saver.save_async(state, 1)
        before = state["params"].embed.detach().clone()
        with torch.no_grad():
            state["params"].embed.add_(1.0)       # training goes on in place
        saver.save_async(state, 2)                 # waits for the first
        saver.wait()
        assert ckpt.latest_step(d) == 2
        with np.load(f"{d}/step00000001.npz") as data:
            raw = data["params/embed::bf16"]
        assert torch.equal(torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16),
                           before)


def test_cli_trains_on_the_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        train_cli.main(["--device", "cpu", "--steps", "20", "--batch", "2",
                        "--seq", "16", "--microbatches", "2", "--ckpt", d])
        assert ckpt.latest_step(d) == 19
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "h2o-danube-1.8b-reduced" and out["steps"] == 20
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_training_entry_points_default_to_cuda_and_reject_unported_inputs():
    cfg = get_arch("starcoder2").reduced()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            init_train_state(cfg, TrainConfig())
        with pytest.raises((RuntimeError, AssertionError)):
            next(data_iter(cfg, 2, 16))
    model = init_train_state(cfg, TrainConfig(), device="cpu")["params"]
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    # a config without a prefix or an encoder ignores patches and frames, as
    # repro's forward does; a layer kind that repro does not have raises
    with torch.no_grad():
        plain = forward(model, {"tokens": tokens})
        for extra in ("patches", "frames"):
            got = forward(model, {"tokens": tokens, extra: torch.ones(1, 4, cfg.d_model)})
            assert torch.equal(got, plain), extra
    unknown = dataclasses.replace(cfg, layer_pattern=("no-such-kind", "attn"))
    with pytest.raises(NotImplementedError, match="unknown layer kind 'no-such-kind'"):
        init_train_state(unknown, TrainConfig(), device="cpu")
