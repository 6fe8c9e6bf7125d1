"""The port's decode path and serving engine against the JAX package's.

Reduced StarCoder2 with float32 weights made by ``repro``'s ``init_params``
(biases and norm parameters replaced by seeded random values, so that every
parameter matters) and converted with ``params_from_jax``.  The port runs
on the CPU, where its flash-decode wrapper takes the plain version.  Also
holds the port's engine to the admission, completion and leftover contract
of ``tests/test_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step, init_cache
from repro_torch.serve import Request, ServeEngine

CACHE_TOL = 2e-2            # the cache is bfloat16


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port model) on the same weights."""
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
    params = jax.tree.map(jnp.asarray, tree)
    tcfg = get_arch("starcoder2").reduced()
    model = params_from_jax(tcfg, tree, device="cpu")
    return jcfg, params, tcfg, model


def test_configs_agree(pair):
    jcfg, _, tcfg, _ = pair
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


def test_decode_steps_match_jax(pair):
    jcfg, params, tcfg, model = pair
    b, max_len = 3, 16
    jcache = jax_init_cache(params, jcfg, b, max_len)
    tcache = init_cache(model, b, max_len)
    rng = np.random.default_rng(3)
    # Every lane starts its request at position 0, as the engine does; lanes
    # 1 and 2 then start a new request, so their later slots hold stale,
    # larger positions from the earlier one.
    schedule = [[0, 0, 0], [1, 1, 1], [2, 2, 2], [3, 0, 3], [4, 1, 0], [5, 2, 1]]
    for positions in np.asarray(schedule, np.int32):
        tokens = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jnext, jcache = jax_decode_step(params, jcfg, jcache,
                                        jnp.asarray(tokens), jnp.asarray(positions))
        tnext, tcache = decode_step(model, tcache, tokens, positions)
        assert tnext.dtype == torch.int32
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        assert not jcache["rest"] and len(jcache["groups"]) == 1
        jg = jcache["groups"][0]
        for i, c in enumerate(tcache):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    c[name].float().numpy(), np.asarray(jg[name][i], np.float32),
                    atol=CACHE_TOL, rtol=CACHE_TOL)
            np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jg["pos"][i]))


def test_decode_steps_past_max_len_match_jax(pair):
    """Positions past the cache's length wrap into slot position % max_len,
    as in ``repro``: lane 0 runs to twice the cache, lane 1 restarts at 0
    after wrapping, lane 2 stays short."""
    jcfg, params, tcfg, model = pair
    b, max_len = 3, 8
    jcache = jax_init_cache(params, jcfg, b, max_len)
    tcache = init_cache(model, b, max_len)
    rng = np.random.default_rng(4)
    for step in range(17):
        positions = np.asarray([step, step if step < 11 else step - 11, step % 4],
                               np.int32)
        tokens = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jnext, jcache = jax_decode_step(params, jcfg, jcache,
                                        jnp.asarray(tokens), jnp.asarray(positions))
        tnext, tcache = decode_step(model, tcache, tokens, positions)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        jg = jcache["groups"][0]
        for i, c in enumerate(tcache):
            np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jg["pos"][i]))
            np.testing.assert_allclose(c["k"].float().numpy(),
                                       np.asarray(jg["k"][i], np.float32),
                                       atol=CACHE_TOL, rtol=CACHE_TOL)


def _awaited(jeng):
    """repro's engine hands its host token/position arrays to jnp.asarray,
    which may alias them on the CPU, and mutates them while the step it
    dispatched may not have run yet.  Waiting for each step makes the
    reference deterministic."""
    step = jeng._step
    jeng._step = lambda *a: jax.block_until_ready(step(*a))
    return jeng


def test_prompt_longer_than_max_len_wraps_like_jax(pair):
    jcfg, params, tcfg, model = pair
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (10, 3, 13)]
    streams = {}
    for name, eng, req in (
            ("jax", _awaited(JaxServeEngine(jcfg, params, max_batch=2, max_len=8)),
             JaxRequest),
            ("torch", ServeEngine(tcfg, model, max_batch=2, max_len=8, device="cpu"),
             Request)):
        reqs = [req(i, list(p), max_new=6) for i, p in enumerate(prompts)]
        assert eng.submit(reqs[0]) and eng.submit(reqs[1])
        eng.step()
        assert eng.run_until_done() == []
        assert eng.submit(reqs[2])                # reuses a slot, wraps again
        assert eng.run_until_done() == []
        streams[name] = [r.out for r in reqs]
        assert all(r.done for r in reqs)
    assert streams["torch"] == streams["jax"]


def test_empty_prompt_raises_and_leaves_every_slot_free(pair):
    _, _, cfg, model = pair
    eng = ServeEngine(cfg, model, max_batch=2, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(0, [], max_new=3))
    assert eng.slots == [None, None]
    (a,) = reqs(1, cfg)
    assert eng.submit(a) and eng.slots[0] is a


def _drive(engine, request_cls, vocab):
    """3 requests through 2 slots: slot reuse plus one capacity pause and
    restore.  Returns every request's token stream and the step counts."""
    rng = np.random.default_rng(5)
    reqs = [request_cls(i, rng.integers(0, vocab, n).tolist(), max_new=m)
            for i, (n, m) in enumerate([(3, 5), (4, 7), (2, 4)])]
    log = [engine.submit(reqs[0]), engine.submit(reqs[1]),
           engine.submit(reqs[2])]                       # rejected: full
    log.append(engine.step())
    log.append(engine.set_capacity(1))
    log += [engine.step(), engine.step()]                # slot 1 frozen
    log.append(len(engine.run_until_done()))             # slot 1 parked
    log.append(engine.set_capacity(2))
    log.append(engine.submit(reqs[2]))                   # reuses slot 0
    log.append(len(engine.run_until_done()))
    return [r.out for r in reqs], log


def test_serve_engine_streams_match_jax(pair):
    jcfg, params, tcfg, model = pair
    jeng = _awaited(JaxServeEngine(jcfg, params, max_batch=2, max_len=32))
    jstreams, jlog = _drive(jeng, JaxRequest, jcfg.vocab_size)
    tstreams, tlog = _drive(ServeEngine(tcfg, model, max_batch=2, max_len=32,
                                        device="cpu"), Request, tcfg.vocab_size)
    assert tlog == jlog
    assert tstreams == jstreams
    assert [len(s) for s in tstreams] == [5, 7, 4]


# ------------------------------------------------------------------ the
# admission, completion and leftover checks of tests/test_serve.py


def make_engine(pair, **kw):
    _, _, cfg, model = pair
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    return ServeEngine(cfg, model, device="cpu", **kw)


def reqs(n, cfg, prompt_len=3, max_new=4, start=0):
    rng = np.random.default_rng(7 + start)
    return [Request(start + i,
                    rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                    max_new=max_new) for i in range(n)]


def test_submit_rejects_when_batch_full(pair):
    eng = make_engine(pair)
    a, b, c = reqs(3, pair[2])
    assert eng.submit(a) and eng.submit(b)
    assert not eng.submit(c)
    assert c.out is None
    assert eng.slots == [a, b]


def test_step_counts_active_and_completes_at_max_new(pair):
    eng = make_engine(pair)
    (a,) = reqs(1, pair[2], max_new=3)
    eng.submit(a)
    assert len(a.out) == 1
    assert eng.step() == 1
    assert eng.step() == 1
    assert a.done and len(a.out) == 3
    assert eng.slots[0] is None
    assert eng.step() == 0


def test_slot_reuse_after_completion(pair):
    eng = make_engine(pair)
    a, b = reqs(2, pair[2], max_new=2)
    eng.submit(a)
    eng.step()
    assert a.done and eng.slots[0] is None
    assert eng.submit(b)
    assert eng.slots[0] is b
    assert eng.run_until_done() == [] and b.done
    assert len(b.out) == 2 and len(a.out) == 2


def test_max_len_forces_completion(pair):
    eng = make_engine(pair, max_len=8)
    (a,) = reqs(1, pair[2], prompt_len=3, max_new=100)
    eng.submit(a)
    assert eng.run_until_done() == []
    assert a.done and len(a.out) < 100


def test_run_until_done_surfaces_step_budget_leftovers(pair):
    eng = make_engine(pair)
    a, b = reqs(2, pair[2], max_new=50)
    eng.submit(a)
    eng.submit(b)
    assert eng.run_until_done(max_steps=2) == [a, b]
    assert not a.done and not b.done
    assert eng.run_until_done() == []
    assert a.done and b.done


def test_capacity_pause_freezes_and_resumes(pair):
    eng = make_engine(pair)
    a, b = reqs(2, pair[2], max_new=6)
    eng.submit(a)
    eng.submit(b)
    assert eng.set_capacity(1) == 1
    frozen = list(b.out)
    assert eng.step() == 1
    assert len(b.out) == len(frozen)
    assert eng.run_until_done() == [b] and a.done
    assert b.out == frozen
    eng.set_capacity(2)
    assert eng.run_until_done() == []
    assert b.done and len(b.out) == 6


def test_capacity_zero_blocks_admission(pair):
    eng = make_engine(pair)
    assert eng.set_capacity(0) == 0
    (a,) = reqs(1, pair[2])
    assert not eng.submit(a)
    assert eng.set_capacity(99) == eng.max_batch
    assert eng.submit(a)
