"""The port's VLM path against the JAX package's, on the CPU: PaliGemma-3B's
prefix-LM with a vision stub.

The reduced config (d_model 64, MQA with 4 query heads, head_dim 16, a
prefix of 4 patch embeddings) gets float32 weights from ``repro``'s
``init_params`` (norm scales replaced by seeded random values, so that
every parameter matters), converted with ``params_from_jax``; a JAX grads
tree has the params' structure, so the same function maps it.  The port
runs on the CPU, where its kernel wrappers take the plain versions.  The
patches come first and attend to each other both ways; the loss drops
their rows, as ``repro``'s ``loss_fn`` does.  Serving is text only, as in
``repro``.  The plain flash version is also held, under the prefix mask at
PaliGemma's head dim 256 and MQA, to the Pallas kernel in interpret mode
and to ``jax.vjp`` of ``flash_attention_xla``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.layers import flash_attention_xla
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import loss_fn as jax_loss_fn
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_ref)
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                lm_loss)
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, init_opt_state, loss_fn,
                               make_train_step, synthetic_batch)

# the tolerances of tests/test_torch_windowed.py (float32 on both sides)
# and tests/test_kernels.py's bf16 tolerance
ACT_TOL = 2e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-4
BF16_TOL = 2e-2
# Adam's eps in the train-step comparison, as tests/test_torch_windowed.py:
# at the first step one entry of layer 0's wv has a gradient of 2e-10, where
# float32 sums in another order differ by a sizeable share; at eps 1e-8
# Adam turns that into moves of a sizeable share of lr.
ADAM_EPS = 1e-6
ARCH = "paligemma"
SEQ = 40                       # 4 patches + 36 tokens


def _perturbed(dtype=jnp.float32):
    jcfg = jax_get_arch(ARCH).reduced()
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        a = np.array(leaf, copy=True)     # own memory, no view of a JAX buffer
        if getattr(path[-1], "key", None) == "scale":
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jcfg, jax.tree_util.tree_map_with_path(perturb, params), get_arch(ARCH).reduced()


@pytest.fixture(scope="module")
def pair():
    return _perturbed()


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(tcfg, tree):
    return params_from_jax(tcfg, tree, device="cpu")


def test_config_agrees_and_resolves_by_name_and_alias():
    full_j, full_t = jax_get_arch(ARCH), get_arch(ARCH)
    assert full_t.name == "paligemma-3b" and get_arch(full_t.name) is full_t
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert full_t.param_count() == full_j.param_count()
    assert (full_t.prefix_len, full_t.reduced().prefix_len) == (256, 4)
    assert not full_t.is_encdec and full_t.head_dim == 256 and full_t.n_kv_heads == 1


def test_init_params_builds_repro_layers():
    """The port's own weights have the parameter names, shapes and dtypes of
    the JAX package's: attention layers with a GeGLU MLP, no encoder."""
    tcfg = get_arch(ARCH).reduced()
    model = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [layer.kind for layer in model.layers] == ["attn", "attn"]
    assert model.enc is None and all(layer.xattn is None for layer in model.layers)
    tree = jax_init_params(jax_get_arch(ARCH).reduced(), jax.random.PRNGKey(0))
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, tree),
                                device="cpu").named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert (p.shape, p.dtype) == (want[name].shape, want[name].dtype), name


@pytest.fixture(scope="module")
def jax_ref(pair):
    """The JAX hidden states (prefix rows included), loss (prefix rows
    dropped) and gradients of one batch, in one jitted call."""
    jcfg, tree, tcfg = pair
    batch = synthetic_batch(tcfg, 0, 2, SEQ)

    def loss_and_hidden(p, b):
        return jax_loss_fn(p, jcfg, b, JaxTrainConfig()), jax_forward(p, jcfg, b)

    (jloss, jh), jgrads = jax.jit(jax.value_and_grad(loss_and_hidden, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _jbatch(batch))
    return batch, np.asarray(jh), float(jloss), jax.tree.map(np.asarray, jgrads)


def test_forward_and_loss_match_jax(pair, jax_ref):
    _, tree, tcfg = pair
    batch, jh, jloss, _ = jax_ref
    assert batch["patches"].shape == (2, 4, tcfg.d_model)
    assert batch["tokens"].shape == (2, SEQ - 4)
    model = _model(tcfg, tree)
    with torch.no_grad():
        h = forward(model, _tbatch(batch))
        loss = loss_fn(model, _tbatch(batch), TrainConfig())
    assert h.shape == (2, SEQ, tcfg.d_model) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), jh, atol=ACT_TOL, rtol=ACT_TOL)
    np.testing.assert_allclose(loss.item(), jloss, rtol=ACT_TOL)
    # the loss reads the text rows only
    with torch.no_grad():
        text = lm_loss(model, h[:, 4:], torch.from_numpy(batch["labels"]))
    assert text.item() == loss.item()


def test_every_gradient_leaf_matches_jax(pair, jax_ref):
    _, tree, tcfg = pair
    batch, _, jloss, jgrads = jax_ref
    model = _model(tcfg, tree)
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, _tbatch(batch), TrainConfig())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = dict(params_from_jax(tcfg, jgrads, device="cpu").named_parameters())
    assert sorted(grads) == sorted(want)
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
        batch = synthetic_batch(tcfg, i, 2, SEQ)
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


def test_bf16_forward_and_loss_match_jax():
    """bf16 weights, float32 patches cast to bf16 before the tokens: the
    hidden states keep bf16 and agree within the bf16 tolerance of their
    largest entry (the two sides round bf16 intermediates apart, so an entry
    near zero after a cancellation may differ by an ulp of its terms)."""
    jcfg, tree, tcfg = _perturbed(jnp.bfloat16)
    batch = synthetic_batch(tcfg, 1, 2, SEQ)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh = jax_forward(jparams, jcfg, _jbatch(batch))
    jloss = jax_loss_fn(jparams, jcfg, _jbatch(batch), JaxTrainConfig())
    model = _model(tcfg, tree)
    with torch.no_grad():
        h = forward(model, _tbatch(batch))
        loss = loss_fn(model, _tbatch(batch), TrainConfig())
    assert jh.dtype == jnp.bfloat16 and h.dtype == torch.bfloat16
    jh = np.asarray(jh, np.float32)
    assert np.abs(h.float().numpy() - jh).max() <= BF16_TOL * max(1.0, np.abs(jh).max())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)


def test_prefix_attends_both_ways_and_text_causally():
    """A change to the last patch reaches every prefix row (bidirectional
    prefix) and every text row; a change to the last token reaches no
    earlier row."""
    cfg = get_arch(ARCH).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu",
                        dtype=torch.float32)
    base = _tbatch(synthetic_batch(cfg, 0, 1, SEQ))
    patches = base["patches"].clone()
    patches[:, -1] += 1.0
    tokens = base["tokens"].clone()
    tokens[:, -1] = (tokens[:, -1] + 1) % cfg.vocab_size
    with torch.no_grad():
        h = forward(model, base)
        hp = forward(model, {**base, "patches": patches})
        ht = forward(model, {**base, "tokens": tokens})
    rows = (hp - h).abs().amax(-1)[0]
    assert bool((rows > 0).all())
    assert torch.equal(ht[:, :-1], h[:, :-1]) and not torch.equal(ht[:, -1], h[:, -1])


def test_decode_steps_match_jax(pair):
    """Text-only decode, as ``repro`` serves the VLM: lane 0 runs to 46,
    lane 1 restarts at 0 after 30 steps, lane 2 cycles through short
    sequences."""
    jcfg, tree, tcfg = pair
    jparams = jax.tree.map(jnp.asarray, tree)
    model = _model(tcfg, tree)
    b, max_len = 3, 48
    jcache = jax_init_cache(jparams, jcfg, b, max_len)
    tcache = init_cache(model, b, max_len)
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
    """4 requests through 3 slots, one of them reused."""
    rng = np.random.default_rng(5)
    reqs = [request_cls(i, rng.integers(0, vocab, n).tolist(), max_new=m)
            for i, (n, m) in enumerate([(20, 6), (3, 9), (15, 4), (25, 5)])]
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


# PaliGemma's attention: MQA (8 query heads over 1 KV head) at head dim 256,
# under a prefix; S = 96 with a prefix of 33 (not a whole 64-key tile)
PREFIX_CASE = dict(b=2, s=96, hq=8, hkv=1, d=256, prefix=33)


def _flash_inputs(seed, dtype):
    c = PREFIX_CASE
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (c["b"], c["s"], c["hq"], c["d"]), (c["b"], c["s"], c["hkv"], c["d"]),
        (c["b"], c["s"], c["hkv"], c["d"]), (c["b"], c["s"], c["hq"], c["d"]))]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_prefix_mask_at_d256_matches_pallas_and_ref(dtype):
    (qj, kj, vj, _), (qt, kt, vt, _) = _flash_inputs(21, dtype)
    kw = dict(causal=True, prefix_len=PREFIX_CASE["prefix"])
    tol = {"float32": ACT_TOL, "bfloat16": BF16_TOL}[dtype]
    out, lse = flash_attention_fwd(qt, kt, vt, **kw)
    assert out.dtype == qt.dtype and lse.shape == (2, 8, 96)
    for want in (attention_ref(qj, kj, vj, **kw),
                 flash_attention_pallas(qj, kj, vj, block_q=64, block_k=64, interpret=True,
                                        **kw)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    # the prefix is live: a causal mask alone gives other rows in the prefix
    causal = flash_attention_fwd_ref(qt, kt, vt, causal=True)[0]
    assert not torch.allclose(causal[:, :32].float(), out[:, :32].float(), atol=tol)
    assert torch.equal(causal[:, 33:], out[:, 33:])


def test_plain_flash_prefix_backward_at_d256_matches_jax():
    (qj, kj, vj, gj), (qt, kt, vt, gt) = _flash_inputs(22, "float32")
    kw = dict(causal=True, prefix_len=PREFIX_CASE["prefix"])
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_xla(q, k, v, block=64, **kw),
                     qj, kj, vj)
    out, lse = flash_attention_fwd_ref(qt, kt, vt, **kw)
    grads = flash_attention_bwd_ref(qt, kt, vt, out, lse, gt, block=64, **kw)
    for t, j, x in zip(grads, vjp(gj), (qt, kt, vt)):
        j = np.asarray(j)
        assert t.shape == x.shape and t.dtype == x.dtype
        assert np.abs(t.numpy() - j).max() <= GRAD_TOL * max(1.0, np.abs(j).max())
