"""The port's encoder-decoder path against the JAX package's, on the CPU:
Whisper-small's encoder, cross-attention and encoder cache.

The reduced config (d_model 64, 2 encoder layers over 16 frames, 2 decoder
layers, LayerNorm, GELU) gets weights from ``repro``'s ``init_params``
(norm scales and biases replaced by seeded random values, so that every
parameter matters), converted with ``params_from_jax``, which unstacks the
encoder's layers.  The port runs on the CPU, where its kernel wrappers take
the plain versions.  The frames are float32, as ``synthetic_batch`` makes
them, so with bf16 weights the encoder and the cross K/V run in float32 and
the decoder in bf16, on both sides.  Neither engine takes frames: the
caller fills ``engine.cache`` with ``encode_to_cache``.  The plain flash
version is also held, non-causal with Sq != Sk and key lengths that are not
a multiple of the 64-key tile, to the Pallas kernel in interpret mode and
to ``jax.vjp`` of ``flash_attention_xla``, also with a bf16 q over float32
k/v; flash-decode's lengths form with a bf16 q over a float32 cache to
``decode_attention_xla``.
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
from repro.models import lm_loss as jax_lm_loss
from repro.models.layers import decode_attention_xla, flash_attention_xla
from repro.models.transformer import encode as jax_encode
from repro.models.transformer import encode_to_cache as jax_encode_to_cache
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_ref)
from repro_torch.models import (decode_step, encode, encode_to_cache, forward, init_cache,
                                init_params, lm_loss)
from repro_torch.models.layers import flash_attention as layers_flash_attention
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (OptConfig, TrainConfig, init_opt_state, make_train_step,
                               synthetic_batch)

# the tolerances of tests/test_torch_windowed.py (float32 on both sides)
# and tests/test_kernels.py's bf16 tolerance
ACT_TOL = 2e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-4
BF16_TOL = 2e-2
ARCH = "whisper"
SEQ = 24


def _perturbed(dtype=jnp.float32, **extra):
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), **extra)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", None)
        a = np.array(leaf, copy=True)     # own memory, no view of a JAX buffer
        if name == "scale":               # LayerNorm's scale multiplies
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), **extra)
    return jcfg, jax.tree_util.tree_map_with_path(perturb, params), tcfg


@pytest.fixture(scope="module")
def pair():
    return _perturbed()


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(tcfg, tree):
    return params_from_jax(tcfg, tree, device="cpu")


def _frames(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)


def test_config_agrees_and_resolves_by_name_and_alias():
    full_j, full_t = jax_get_arch(ARCH), get_arch(ARCH)
    assert full_t.name == "whisper-small" and get_arch(full_t.name) is full_t
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert dataclasses.asdict(full_j.reduced()) == dataclasses.asdict(full_t.reduced())
    assert full_t.param_count() == full_j.param_count()
    assert full_t.is_encdec and (full_t.enc_layers, full_t.enc_seq) == (12, 1500)
    red = full_t.reduced()
    assert red.is_encdec and (red.enc_layers, red.enc_seq) == (2, 16)
    # the encoder's and the cross-attention's weights count
    assert full_t.param_count() > dataclasses.replace(full_t, enc_layers=0).param_count()


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_init_params_builds_repro_layers(qkv_bias):
    """The port's own weights have the parameter names, shapes and dtypes of
    the JAX package's: decoder layers with normx and a cross-attention
    without q/k/v biases, an encoder of ``"enc"`` layers and a final norm."""
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), qkv_bias=qkv_bias)
    model = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [layer.kind for layer in model.enc.layers] == ["enc", "enc"]
    assert all(layer.xattn is None for layer in model.enc.layers)
    assert all(sorted(layer.xattn) == ["wk", "wo", "wq", "wv"] for layer in model.layers)
    assert all(("bq" in layer.attn) == qkv_bias for layer in model.layers)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), qkv_bias=qkv_bias)
    tree = jax_init_params(jcfg, jax.random.PRNGKey(0))
    want = dict(params_from_jax(tcfg, jax.tree.map(np.asarray, tree),
                                device="cpu").named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    assert {"enc.layers.1.attn.wq", "enc.final_norm.bias", "layers.0.xattn.wk",
            "layers.1.normx.scale"} <= set(got)
    for name, p in got.items():
        assert (p.shape, p.dtype) == (want[name].shape, want[name].dtype), name


@pytest.fixture(scope="module")
def jax_ref(pair):
    """The JAX hidden states, loss and gradients of one batch, in one
    jitted call."""
    jcfg, tree, tcfg = pair
    batch = synthetic_batch(tcfg, 0, 2, SEQ)

    def loss_and_hidden(p, b):
        h = jax_forward(p, jcfg, b)
        return jax_lm_loss(p, jcfg, h, b["labels"]), h

    (jloss, jh), jgrads = jax.jit(jax.value_and_grad(loss_and_hidden, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), _jbatch(batch))
    return batch, np.asarray(jh), float(jloss), jax.tree.map(np.asarray, jgrads)


def test_encode_matches_jax(pair):
    jcfg, tree, tcfg = pair
    frames = _frames(tcfg, 2, 1)
    want = np.asarray(jax_encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(frames)))
    with torch.no_grad():
        got = encode(_model(tcfg, tree), torch.from_numpy(frames))
    assert got.shape == frames.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ACT_TOL, rtol=ACT_TOL)


def test_forward_and_loss_match_jax(pair, jax_ref):
    _, tree, tcfg = pair
    batch, jh, jloss, _ = jax_ref
    assert batch["frames"].shape == (2, 16, tcfg.d_model)
    model = _model(tcfg, tree)
    with torch.no_grad():
        h = forward(model, _tbatch(batch))
        loss = lm_loss(model, h, torch.from_numpy(batch["labels"]))
        plain = forward(model, {"tokens": torch.from_numpy(batch["tokens"])})
    assert h.shape == (2, SEQ, tcfg.d_model) and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), jh, atol=ACT_TOL, rtol=ACT_TOL)
    np.testing.assert_allclose(loss.item(), jloss, rtol=ACT_TOL)
    assert not torch.allclose(plain, h, atol=1e-3)       # the cross-attention is live


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
    assert any(n.startswith("enc.layers.0.") for n in grads)
    np.testing.assert_allclose(loss.item(), jloss, rtol=ACT_TOL)
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


def test_bf16_weights_keep_repro_dtypes_and_values():
    """bf16 weights over float32 frames: the encoder and the cross K/V run in
    float32, the decoder in bf16, on both sides; values agree within the
    bf16 tolerance of their largest entry (the two sides round bf16
    intermediates apart)."""
    jcfg, tree, tcfg = _perturbed(jnp.bfloat16)
    batch = synthetic_batch(tcfg, 1, 2, SEQ)
    jparams = jax.tree.map(jnp.asarray, tree)
    je = jax_encode(jparams, jcfg, jnp.asarray(batch["frames"]))
    jh = jax_forward(jparams, jcfg, _jbatch(batch))
    jloss = jax_lm_loss(jparams, jcfg, jh, jnp.asarray(batch["labels"]))
    model = _model(tcfg, tree)
    tb = _tbatch(batch)
    with torch.no_grad():
        e = encode(model, tb["frames"])
        h = forward(model, tb)
        loss = lm_loss(model, h, tb["labels"])
    assert (je.dtype, jh.dtype) == (jnp.float32, jnp.bfloat16)
    assert (e.dtype, h.dtype) == (torch.float32, torch.bfloat16)
    # the encoder computes in float32 on both sides (bf16 weights promoted)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=ACT_TOL, rtol=ACT_TOL)
    jh = np.asarray(jh, np.float32)
    assert np.abs(h.float().numpy() - jh).max() <= BF16_TOL * max(1.0, np.abs(jh).max())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_to_cache_matches_jax(dtype):
    """Every decoder layer's xk and xv after ``encode_to_cache``: the shapes
    and dtypes of JAX's (float32 over float32 frames, beside a bf16
    self-attention cache), and its values."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg, tree, tcfg = _perturbed(jdt)
    jparams = jax.tree.map(jnp.asarray, tree)
    frames = _frames(tcfg, 3, 2)
    jcache = jax_encode_to_cache(jparams, jcfg, jax_init_cache(jparams, jcfg, 3, 32),
                                 jnp.asarray(frames))
    model = _model(tcfg, tree)
    cache = init_cache(model, 3, 32)
    assert cache[0]["xk"].shape == (3, 16, 2, 16) and cache[0]["xk"].dtype == torch.bfloat16
    assert encode_to_cache(model, cache, frames) is cache
    jlayers = [jax.tree.map(lambda x: x[g], jcache["groups"][0]) for g in range(2)]
    for c, jc in zip(cache, jlayers):
        assert c["k"].dtype == torch.bfloat16 and jc["k"].dtype == jnp.bfloat16
        for name in ("xk", "xv"):
            want = np.asarray(jc[name])
            assert want.dtype == np.float32 and c[name].dtype == torch.float32
            assert c[name].shape == want.shape == (3, 16, 2, 16)
            np.testing.assert_allclose(c[name].numpy(), want, atol=ACT_TOL, rtol=ACT_TOL)


def test_decode_steps_read_the_encoder_cache_like_jax(pair):
    """Caches filled by ``encode_to_cache`` on both sides, then 30 decode
    steps: lane 0 runs on, lane 1 restarts at 0 after 20 steps, lane 2
    cycles.  The same steps over a cache without the encoder's K/V give
    other tokens, so the steps read it."""
    jcfg, tree, tcfg = pair
    jparams = jax.tree.map(jnp.asarray, tree)
    model = _model(tcfg, tree)
    b, max_len = 3, 32
    frames = _frames(tcfg, b, 4)
    jcache = jax_encode_to_cache(jparams, jcfg, jax_init_cache(jparams, jcfg, b, max_len),
                                 jnp.asarray(frames))
    tcache = encode_to_cache(model, init_cache(model, b, max_len), frames)
    blank = init_cache(model, b, max_len)
    jstep = jax.jit(lambda c, t, pos: jax_decode_step(jparams, jcfg, c, t, pos))
    rng = np.random.default_rng(3)
    differ = 0
    for i in range(30):
        tokens = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        positions = np.asarray([i, i if i < 20 else i - 20, i % 7], np.int32)
        jnext, jcache = jstep(jcache, jnp.asarray(tokens), jnp.asarray(positions))
        tnext, tcache = decode_step(model, tcache, tokens, positions)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext), err_msg=f"step {i}")
        bnext, blank = decode_step(model, blank, tokens, positions)
        differ += int((bnext != tnext).sum())
    assert differ > 0


def _awaited(jeng):
    """Wait for each JAX engine step (tests/test_torch_serve.py says why)."""
    step = jeng._step
    jeng._step = lambda *a: jax.block_until_ready(step(*a))
    return jeng


def _drive(engine, request_cls, vocab):
    """4 requests through 3 slots, one of them reused."""
    rng = np.random.default_rng(5)
    reqs = [request_cls(i, rng.integers(0, vocab, n).tolist(), max_new=m)
            for i, (n, m) in enumerate([(12, 6), (3, 9), (10, 4), (14, 5)])]
    log = [engine.submit(reqs[0]), engine.submit(reqs[1])]
    log.append(engine.step())
    log.append(engine.submit(reqs[2]))
    log.append(len(engine.run_until_done()))
    log.append(engine.submit(reqs[3]))
    log.append(len(engine.run_until_done()))
    return [r.out for r in reqs], log


def test_serve_engine_streams_match_jax(pair):
    """Neither engine takes frames: the caller fills each engine's cache
    with ``encode_to_cache`` before the requests arrive."""
    jcfg, tree, tcfg = pair
    frames = _frames(tcfg, 3, 6)
    jparams = jax.tree.map(jnp.asarray, tree)
    jeng = _awaited(JaxServeEngine(jcfg, jparams, max_batch=3, max_len=32))
    jeng.cache = jax_encode_to_cache(jparams, jcfg, jeng.cache, jnp.asarray(frames))
    jstreams, jlog = _drive(jeng, JaxRequest, jcfg.vocab_size)
    model = _model(tcfg, tree)
    eng = ServeEngine(tcfg, model, max_batch=3, max_len=32, device="cpu")
    eng.cache = encode_to_cache(model, eng.cache, frames)
    tstreams, tlog = _drive(eng, Request, tcfg.vocab_size)
    assert tlog == jlog
    assert tstreams == jstreams
    assert [len(s) for s in tstreams] == [6, 9, 4, 5]


# Whisper's cross-attention: non-causal, Sq != Sk, key lengths that are not
# a multiple of the 64-key tile (1500 at full size)
CROSS_CASES = [(45, 150, 4, 4, 64), (150, 150, 2, 2, 64), (20, 77, 4, 2, 16)]
CROSS_IDS = ["cross 45x150", "encoder 150x150", "GQA 20x77 D=16"]


def _flash_inputs(seed, b, sq, sk, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,hq,hkv,d", CROSS_CASES, ids=CROSS_IDS)
def test_plain_flash_noncausal_rectangular_matches_pallas_and_ref(dtype, sq, sk, hq, hkv, d):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    arrays = _flash_inputs(sq + sk, 2, sq, sk, hq, hkv, d)[:3]
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in arrays)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in arrays)
    tol = {"float32": ACT_TOL, "bfloat16": BF16_TOL}[dtype]
    out, lse = flash_attention_fwd(qt, kt, vt, causal=False)
    assert out.dtype == tdt and out.shape == qt.shape and lse.shape == (2, hq, sq)
    for want in (attention_ref(qj, kj, vj, causal=False),
                 flash_attention_pallas(qj, kj, vj, causal=False, block_q=64, block_k=64,
                                        interpret=True)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,sk,hq,hkv,d", CROSS_CASES, ids=CROSS_IDS)
def test_plain_flash_noncausal_rectangular_backward_matches_jax(sq, sk, hq, hkv, d):
    arrays = _flash_inputs(7 + sk, 2, sq, sk, hq, hkv, d)
    qj, kj, vj, gj = (jnp.asarray(a) for a in arrays)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_xla(q, k, v, causal=False, block=64),
                     qj, kj, vj)
    out, lse = flash_attention_fwd_ref(qt, kt, vt, causal=False)
    grads = flash_attention_bwd_ref(qt, kt, vt, out, lse, gt, causal=False, block=64)
    for t, j, x in zip(grads, vjp(gj), (qt, kt, vt)):
        j = np.asarray(j)
        assert t.shape == x.shape and t.dtype == x.dtype
        assert np.abs(t.numpy() - j).max() <= GRAD_TOL * max(1.0, np.abs(j).max())


def test_cross_attention_of_bf16_q_over_float32_kv_matches_jax():
    """The decoder's cross-attention in training: bf16 q over float32 k/v
    computes in float32 and returns bf16, with dq in bf16 and dk, dv in
    float32, as ``flash_attention_xla``'s custom VJP gives them."""
    q, k, v, g = _flash_inputs(5, 2, 45, 150, 4, 4, 64)
    qj, gj = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    jout, vjp = jax.vjp(lambda q, k, v: flash_attention_xla(q, k, v, causal=False),
                        qj, kj, vj)
    qt = torch.from_numpy(q).to(torch.bfloat16).requires_grad_()
    kt, vt = (torch.from_numpy(a).requires_grad_() for a in (k, v))
    out = layers_flash_attention(qt, kt, vt, causal=False)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(jout, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g).to(torch.bfloat16))
    for t, j, x in zip(grads, vjp(gj), (qt, kt, vt)):
        assert t.dtype == x.dtype and j.dtype == {torch.bfloat16: jnp.bfloat16,
                                                  torch.float32: jnp.float32}[x.dtype]
        j = np.asarray(j, np.float32)
        assert np.abs(t.float().numpy() - j).max() <= BF16_TOL * max(1.0, np.abs(j).max())


def test_decode_lengths_form_bf16_q_over_float32_cache_matches_jax():
    """The decode's cross-attention: one bf16 query a head over a float32
    cache, every key live, against ``decode_attention_xla``."""
    rng = np.random.default_rng(8)
    b, s, h, d = 3, 150, 4, 64
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    want = decode_attention_xla(jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k),
                                jnp.asarray(v), jnp.full((b,), s, jnp.int32))
    got = decode_attention(torch.from_numpy(q[:, 0]).to(torch.bfloat16), torch.from_numpy(k),
                           torch.from_numpy(v), torch.full((b,), s, dtype=torch.int32))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32)[:, 0],
                               atol=BF16_TOL, rtol=BF16_TOL)
