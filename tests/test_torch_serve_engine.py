"""The port's LM decode engine and its driver against the reference's.

The continuous-batching and greedy-equals-``decode_step`` cases of the
reference's ``tests/test_substrate.py``; the port's engine, given the
reference's params (``params_from_jax``), emits the reference engine's
greedy tokens request for request; a temperature run is reproducible by
seed and draws the softmax's distribution. ``examples/graph_serve.py``'s
walk-grounded loop at its own size (R-MAT scale 9, a 4-layer d-128 LM)
through both packages (the reference on its ``pallas`` walk backend, in
interpret mode): equal walks (the port keyed by ``ops.seed_from_key``),
prompts, greedy outputs and states after each update round. The engine
and ``launch/serve.py`` default to the card, so on a machine without one
they raise rather than fall back.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import walks as j_walks
from repro.core.dyngraph import BingoConfig as JBingoConfig
from repro.core.dyngraph import from_edges as j_from_edges
from repro.core.updates import batched_update as j_batched_update
from repro.graph.rmat import degree_bias as j_degree_bias
from repro.graph.rmat import rmat_edges as j_rmat_edges
from repro.kernels.ops import seed_from_key
from repro.models import ModelConfig as JModelConfig
from repro.models import init_model as j_init_model
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import ServeRequest as JServeRequest
from repro_torch.core import walks
from repro_torch.core.dyngraph import BingoConfig, from_edges
from repro_torch.core.updates import make_updater
from repro_torch.graph.rmat import degree_bias, rmat_edges
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (ModelConfig, decode_step, init_decode_cache,
                                init_model, params_from_jax)
from repro_torch.serve import DecodeEngine, ServeRequest
from tests.test_torch_models import init_key
from tests.test_torch_state import assert_state_matches

LM = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, d_ff=64, vocab_size=31, dtype="float32")
CFG = ModelConfig(**LM)


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(lambda k: j_init_model(JModelConfig(**LM), k))(
        init_key(0))


def port_params(seed=0):
    return init_model(CFG, torch.Generator().manual_seed(seed))


def test_decode_engine_continuous_batching():
    eng = DecodeEngine(CFG, port_params(), slots=2, max_len=64,
                       device="cpu")
    for i in range(5):
        eng.submit(ServeRequest(rid=i, prompt=[1, 2, 3], max_new_tokens=4))
    done = eng.run()
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        assert r.done and len(r.output) == 4
        assert all(0 <= t < CFG.vocab_size for t in r.output)


def test_decode_engine_greedy_matches_decode_step():
    """Engine output == hand-rolled greedy decode (same cache math)."""
    params = port_params()
    prompt = [1, 2, 3]
    eng = DecodeEngine(CFG, params, slots=1, max_len=64, device="cpu")
    r = ServeRequest(rid=0, prompt=list(prompt), max_new_tokens=3)
    eng.submit(r)
    eng.run()

    cache = init_decode_cache(CFG, 1, 64, dtype=torch.float32, device="cpu")
    toks = list(prompt)
    for t in range(len(prompt) + 2):
        lg, cache = decode_step(params, CFG, torch.tensor([toks[t]]),
                                torch.tensor([t]), cache)
        if t >= len(prompt) - 1:
            toks.append(int(torch.argmax(lg, -1)[0]))
    assert r.output == toks[len(prompt):len(prompt) + 3]


def _requests(cls):
    """Mixed lengths: an empty prompt, one cut by ``max_len``, more
    requests than slots."""
    rng = np.random.default_rng(5)
    out = []
    for i, (n, new) in enumerate([(3, 4), (0, 3), (7, 2), (1, 6), (12, 9),
                                  (5, 1), (2, 5)]):
        prompt = rng.integers(0, LM["vocab_size"], n).tolist()
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=new))
    return out


def test_greedy_tokens_equal_the_reference_engine(jparams):
    jeng = JDecodeEngine(JModelConfig(**LM), jparams, slots=3, max_len=16)
    teng = DecodeEngine(CFG, params_from_jax(jparams, device="cpu"),
                        slots=3, max_len=16, device="cpu")
    for eng, cls in ((jeng, JServeRequest), (teng, ServeRequest)):
        for r in _requests(cls):
            eng.submit(r)
    want, got = jeng.run(), teng.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.output for r in got] == [r.output for r in want]
    assert len(got[-1].output) < 9          # rid 4 stopped by max_len


def test_temperature_is_reproducible_by_seed():
    params = port_params()
    outs = []
    for _ in range(2):
        eng = DecodeEngine(CFG, params, slots=2, max_len=64,
                           temperature=0.8, seed=3, device="cpu")
        for r in _requests(ServeRequest):
            eng.submit(r)
        outs.append([(r.rid, r.output) for r in eng.run()])
    assert outs[0] == outs[1]
    assert all(0 <= t < CFG.vocab_size for _, o in outs[0] for t in o)


def test_temperature_draws_the_softmax():
    """The Gumbel-max draw against softmax(logits / T): chi-square."""
    eng = DecodeEngine(CFG, port_params(), slots=1, max_len=8,
                       temperature=0.7, seed=11, device="cpu")
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0, 0.5]]).expand(60_000, 5)
    counts = torch.bincount(eng._sample(logits), minlength=5).double()
    want = torch.softmax(logits[0].double() / 0.7, -1) * logits.shape[0]
    chi2 = float(((counts - want) ** 2 / want).sum())
    assert chi2 < 18.5                    # 4 dof, p = 0.001


def test_engine_and_driver_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises((RuntimeError, AssertionError)):
        DecodeEngine(CFG, port_params(), slots=1, max_len=8)
    with pytest.raises((RuntimeError, AssertionError)):
        launch_serve.main(["--requests", "1"])


def test_launch_serve_on_the_cpu(capsys):
    done = launch_serve.main(["--device", "cpu", "--requests", "5",
                              "--slots", "2", "--max-new", "3",
                              "--d-model", "32", "--layers", "1"])
    assert len(done) == 5 and all(len(r.output) == 3 for r in done)
    assert "[serve] 5 requests, 15 tokens in " in capsys.readouterr().out


def test_graph_serve_loop_matches_the_reference():
    """``examples/graph_serve.py``'s two waves through both packages."""
    scale = 9
    V = 1 << scale
    src, dst = rmat_edges(scale, 8, seed=0)
    jsrc, jdst = j_rmat_edges(scale, 8, seed=0)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    w = degree_bias(src, dst, V, bias_bits=8)
    np.testing.assert_array_equal(w, j_degree_bias(src, dst, V, bias_bits=8))
    kw = dict(num_vertices=V, capacity=256, bias_bits=8)
    # the example's ``pallas`` backend: whole walks through the walk
    # kernel (interpret mode here) on the counter-hash stream
    jcfg, cfg = JBingoConfig(backend="pallas", **kw), BingoConfig(**kw)
    jstate = j_from_edges(jcfg, src, dst, w)
    state = from_edges(cfg, src, dst, w, device="cpu")
    update = make_updater(cfg)

    lm = dict(name="graph-lm", family="dense", num_layers=4, d_model=128,
              num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=V + 1,
              dtype="float32")
    jlm = JModelConfig(**lm)
    jp = jax.jit(lambda k: j_init_model(jlm, k))(init_key(0))
    jeng = JDecodeEngine(jlm, jp, slots=4, max_len=64)
    teng = DecodeEngine(ModelConfig(**lm), params_from_jax(jp, device="cpu"),
                        slots=4, max_len=64, device="cpu")
    jwalk = jax.jit(lambda s, st, k: j_walks.deepwalk(s, jcfg, st, k,
                                                      length=12))
    jupdate = jax.jit(lambda st, *a: j_batched_update(st, jcfg, *a))

    for wave in range(2):
        seeds = np.random.default_rng(wave).integers(0, V, 6).astype(
            np.int32)
        key = jax.random.key(wave)
        want = np.asarray(jwalk(jstate, jnp.asarray(seeds), key))
        paths = walks.deepwalk(state, cfg, torch.from_numpy(seeds),
                               int(seed_from_key(key)[0]), length=12)
        np.testing.assert_array_equal(paths.numpy(), want)
        for eng, cls in ((jeng, JServeRequest), (teng, ServeRequest)):
            for i, row in enumerate(want):
                ctx = [int(t) for t in row if t >= 0][:16]
                eng.submit(cls(rid=wave * 10 + i, prompt=ctx,
                               max_new_tokens=8))
        jdone, tdone = jeng.run(), teng.run()
        assert [(r.rid, r.prompt, r.output) for r in tdone] == \
            [(r.rid, r.prompt, r.output) for r in jdone]
        assert all(len(r.output) == 8 for r in tdone)

        rng = np.random.default_rng(100 + wave)
        B = 128
        lanes = (np.ones(B, bool), rng.integers(0, V, B).astype(np.int32),
                 rng.integers(0, V, B).astype(np.int32),
                 rng.integers(1, 256, B).astype(np.int32))
        jstate, jstats = jupdate(jstate, *map(jnp.asarray, lanes))
        state, stats = update(state, *map(torch.from_numpy, lanes))
        assert int(stats.ins_applied) == int(jstats.ins_applied) > 0
        assert_state_matches(jstate, state, fp=False)
