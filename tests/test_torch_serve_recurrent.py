"""The port's ``ServeEngine`` on configs with recurrent layers, against the
JAX package, on the CPU.

Reduced Mamba-2 (2 SSD layers) and RecurrentGemma (rglru, rglru, swa;
window 32) with float32 weights made by ``repro``'s ``init_params``
(vectors perturbed as ``tests/test_torch_{mamba2,rglru}.py`` perturb them)
and converted with ``params_from_jax``; both engines keep ``init_cache``'s
bfloat16 cache.  The port's engine masks its lanes (``decode_step``'s
``live``): a request's state advances only on its own steps and a reused
slot starts from zeros.  So each request's token stream must equal JAX's
lockstep decode of that request alone in its lane (``repro.models
.decode_step`` from ``repro.models.init_cache``), through staggered
admission, a pause by ``set_capacity`` and a reused slot.  ``repro``'s
engine advances every lane at every step, so its streams are defined for
the first request into a fresh engine, served alone: there the two
engines must agree.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decode_step, init_cache
from repro_torch.serve import Request, ServeEngine
from test_torch_mamba2 import _perturbed as _mamba2_perturbed
from test_torch_rglru import _perturbed as _rglru_perturbed
from test_torch_serve import _awaited

ARCHS = ["mamba2", "recurrentgemma"]
MAX_BATCH = 3
MAX_LEN = 64
# (prompt length, max_new) of each request, in the order they are submitted
REQUESTS = [(5, 9), (4, 12), (3, 6), (6, 5)]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX config, JAX params, port config, port model) on the same weights."""
    if request.param == "mamba2":
        jcfg, tree, tcfg = _mamba2_perturbed()
    else:
        jcfg, tree, tcfg = _rglru_perturbed(3)       # the reduced config's 3 layers
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tcfg, tree,
                                                                       device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, n).tolist() for n, _ in REQUESTS]


def _drive(eng, vocab):
    """The requests through an engine of MAX_BATCH slots: staggered
    admission, a pause and resume of slot 1, request 3 in the slot that
    request 0 leaves.  Returns the requests and the slot each one took."""
    reqs = [Request(i, p, max_new=m) for i, (p, (_, m)) in enumerate(zip(_prompts(vocab),
                                                                           REQUESTS))]
    lanes = {}

    def submit(r):
        assert eng.submit(r)
        lanes[r.rid] = eng.slots.index(r)

    submit(reqs[0])
    eng.step()
    eng.step()
    submit(reqs[1])                       # prefilled while request 0 is live
    eng.step()
    assert eng.set_capacity(1) == 1       # slot 1 paused: request 1 frozen
    for _ in range(3):
        eng.step()
    assert eng.set_capacity(MAX_BATCH) == MAX_BATCH
    submit(reqs[2])
    while not reqs[0].done:
        eng.step()
    submit(reqs[3])                       # reuses request 0's slot
    assert eng.run_until_done() == []
    assert all(r.done for r in reqs)
    return reqs, lanes


def _jax_alone(jcfg, params, prompt, max_new, lane):
    """JAX's lockstep decode with ``prompt`` in ``lane`` of MAX_BATCH lanes
    (the others fed token 0 at position 0): the prompt a token a step, then
    the greedy tokens, as an engine serves the request.  Each step gets
    arrays of its own: jnp.asarray may alias a host array that a step still
    in flight reads."""
    cache = jax_init_cache(params, jcfg, MAX_BATCH, MAX_LEN)
    step = jax.jit(lambda c, t, p: jax_decode_step(params, jcfg, c, t, p))
    out = []
    for j in range(len(prompt) + max_new - 1):
        tokens = np.zeros((MAX_BATCH, 1), np.int32)
        pos = np.zeros((MAX_BATCH,), np.int32)
        tokens[lane, 0] = prompt[j] if j < len(prompt) else out[-1]
        pos[lane] = j
        nxt, cache = step(cache, jnp.asarray(tokens), jnp.asarray(pos))
        if j >= len(prompt) - 1:
            out.append(int(np.asarray(nxt)[lane]))
    return out


def test_engine_streams_equal_jax_lockstep_of_each_request_alone(pair):
    jcfg, params, tcfg, model = pair
    eng = ServeEngine(tcfg, model, max_batch=MAX_BATCH, max_len=MAX_LEN, device="cpu")
    assert eng.masked
    reqs, lanes = _drive(eng, tcfg.vocab_size)
    assert lanes == {0: 0, 1: 1, 2: 2, 3: 0}
    for r in reqs:
        assert len(r.out) == r.max_new
        want = _jax_alone(jcfg, params, r.prompt, r.max_new, lanes[r.rid])
        assert r.out == want, f"request {r.rid} in slot {lanes[r.rid]}"


def test_engine_without_the_lane_mask_leaks_between_requests(pair):
    """The same drive through an engine that advances every lane at every
    step, as repro's does: some request's stream leaves JAX's decode of it
    alone, so the check above sees a missing mask."""
    jcfg, params, tcfg, model = pair
    eng = ServeEngine(tcfg, model, max_batch=MAX_BATCH, max_len=MAX_LEN, device="cpu")
    eng.masked = False
    reqs, lanes = _drive(eng, tcfg.vocab_size)
    assert any(r.out != _jax_alone(jcfg, params, r.prompt, r.max_new, lanes[r.rid])
               for r in reqs)


def test_first_request_matches_repro_engine(pair):
    """A first request alone in a fresh engine, where repro's stream is
    defined; repro's engine steps are waited for (tests/test_torch_serve.py)."""
    jcfg, params, tcfg, model = pair
    prompt = _prompts(tcfg.vocab_size)[0]
    max_new = REQUESTS[0][1]
    streams = {}
    for name, eng, req in (
            ("jax", _awaited(JaxServeEngine(jcfg, params, max_batch=MAX_BATCH,
                                            max_len=MAX_LEN)), JaxRequest),
            ("torch", ServeEngine(tcfg, model, max_batch=MAX_BATCH, max_len=MAX_LEN,
                                  device="cpu"), Request)):
        r = req(0, list(prompt), max_new=max_new)
        assert eng.submit(r)
        assert eng.run_until_done() == []
        streams[name] = r.out
    assert streams["torch"] == streams["jax"]
    assert len(streams["torch"]) == max_new


def test_live_mask_freezes_the_lanes_that_are_not_live(pair):
    """Lanes outside ``live`` keep every recurrent leaf bit for bit; the
    live lanes' leaves and tokens equal an unmasked step's."""
    _, _, tcfg, model = pair
    rng = np.random.default_rng(4)
    masked = init_cache(model, MAX_BATCH, MAX_LEN)
    for _ in range(3):                    # a state that is not zero
        tokens = rng.integers(0, tcfg.vocab_size, (MAX_BATCH, 1))
        decode_step(model, masked, tokens, np.full(MAX_BATCH, 0))
    free = [{k: v.clone() for k, v in c.items()} for c in masked]
    before = [{k: v.clone() for k, v in c.items()} for c in masked]
    live = torch.tensor([True, False, True])
    tokens = rng.integers(0, tcfg.vocab_size, (MAX_BATCH, 1))
    got, _ = decode_step(model, masked, tokens, np.full(MAX_BATCH, 3), live=live)
    want, _ = decode_step(model, free, tokens, np.full(MAX_BATCH, 3))
    assert torch.equal(got[live], want[live])
    n = 0
    for c, f, b in zip(masked, free, before):
        for name in c:
            if name in ("k", "v", "pos"):
                continue
            n += 1
            assert torch.equal(c[name][1], b[name][1]), name
            assert torch.equal(c[name][live], f[name][live]), name
            assert not torch.equal(f[name][1], b[name][1]), name
    assert n == sum(len(c) for c in masked if "k" not in c)


def test_cli_serves_the_reduced_config(pair, capsys):
    _, _, tcfg, _ = pair
    arch = "mamba2" if tcfg.layer_pattern == ("ssd",) else "recurrentgemma"
    serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "4", "--max-new", "6"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == tcfg.name and out["requests"] == 4 and out["tokens"] == 24


def test_engine_without_recurrent_layers_runs_the_unmasked_step():
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    cfg = get_arch("starcoder2").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert not ServeEngine(cfg, model, device="cpu").masked
