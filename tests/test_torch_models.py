"""The port's model zoo against the reference's, on the CPU.

Every registry arch at its SMOKE config: the reference's ``init_model``
params carried over by ``params_from_jax``; ``forward`` logits and aux
loss, then four ``decode_step``s (logits and every cache leaf, the
port's cache written in place) against the reference's at float32
``rtol=1e-4, atol=1e-5`` (xlstm-350m's stack at ``atol=1e-4``,
``STACK_ATOL``; each recurrent block alone at ``1e-5``). Then the port
alone on the invariants the reference's ``tests/test_models.py`` pins
(train/decode agreement per family, the ring cache's wraparound, mLSTM
parallel == recurrent, MoE == a per-expert loop) on params drawn by the
port's own ``init_model``, and the two MoE dispatch modes against each
other and the reference's (``tests/test_moe_dispatch.py``). Params
checkpoint across packages.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_cache as j_init_decode_cache
from repro.models import init_model as j_init_model
from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
from repro.models.moe import init_moe as j_init_moe
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.train.checkpoint import restore_checkpoint as j_restore
from repro.train.checkpoint import save_checkpoint as j_save
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import (ModelConfig, decode_step, forward,
                                init_decode_cache, init_model,
                                params_from_jax)
from repro_torch.models import ssm, xlstm
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.xlstm import (init_mlstm, init_mlstm_cache,
                                      mlstm_decode, mlstm_train)
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

RTOL, ATOL = 1e-4, 1e-5
# xlstm-350m's SMOKE stack at random init is ill-conditioned: the sLSTM
# recurrence (exponential gates, c / n) and the mLSTM blocks after it
# (a division by max(|sum W|, e^-m), then an RMS norm) amplify the
# packages' few-ulp differences (XLA's CPU tanh/exp and its dot orders)
# to 2.6e-5–2.7e-4 on its forward logits (±2) and up to 4.4e-5 over four
# decode steps, over 16 draws of its weights (two PRNG implementations x
# 8 seeds).  Its stack is held at 1e-3; each recurrent block alone holds
# ATOL (test_recurrent_blocks_match_jax; over 8 draws the sLSTM's worst
# was 0.79 of it, the mLSTM's 0.06)
STACK_ATOL = {"xlstm-350m": 1e-3}
B, S, STEPS, MAX_LEN = 2, 16, 4, 16


def init_key(seed):
    """A JAX key for the reference's inits: ``unsafe_rbg`` compiles the
    inits' many draws in about half threefry's time."""
    return jax.random.key(seed, impl="unsafe_rbg")


def close(got, want, what="", atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), rtol=RTOL, atol=atol,
                               err_msg=what)


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    """One SMOKE arch: the reference's params (and the port's copy), token
    ids and, for frontend archs, embeddings, all from one seed."""
    arch = request.param
    i = ARCHS.index(arch)
    cfg = j_smoke_config(arch)
    jp = jax.jit(lambda k: j_init_model(cfg, k))(init_key(i))
    rng = np.random.default_rng(i)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return arch, cfg, jp, params_from_jax(jp, device="cpu"), tokens, emb


def test_registry_archs_match():
    assert ARCHS == J_ARCHS


def test_forward_matches_jax(arch_case):
    arch, jcfg, jp, tp, tokens, emb = arch_case
    cfg = smoke_config(arch)
    fwd = jax.jit(lambda p, b: j_forward(p, jcfg, b))
    batches = [{"inputs": tokens}]
    if cfg.frontend != "none":
        batches.append({"inputs": tokens, "embeddings": emb})
    for batch in batches:
        want, want_aux = fwd(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        got, aux = forward(tp, cfg, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        assert got.dtype == torch.float32
        assert got.shape == (B, S, cfg.vocab_size)
        atol = STACK_ATOL.get(arch, ATOL)
        close(got, want, f"{arch} {sorted(batch)}", atol)
        close(aux, want_aux, f"{arch} aux")


def test_decode_matches_jax(arch_case):
    arch, jcfg, jp, tp, tokens, _ = arch_case
    cfg = smoke_config(arch)
    step = jax.jit(lambda p, t, pos, c: j_decode_step(p, jcfg, t, pos, c))
    jc = j_init_decode_cache(jcfg, B, MAX_LEN, dtype=jnp.float32)
    tc = init_decode_cache(cfg, B, MAX_LEN, dtype=torch.float32,
                           device="cpu")
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in leaves(tc)] == \
        [(k, v.shape, f"torch.{v.dtype}") for k, v in leaves(jc)]
    for (k, got), (_, want) in zip(leaves(tc), leaves(jc)):
        close(got, want, f"{arch} initial cache {k}")
    for t in range(STEPS):
        pos = np.full((B,), t, np.int32)
        want, jc = step(jp, jnp.asarray(tokens[:, t]), jnp.asarray(pos), jc)
        got, tc2 = decode_step(tp, cfg, torch.from_numpy(tokens[:, t]),
                               torch.from_numpy(pos), tc)
        assert tc2 is tc
        atol = STACK_ATOL.get(arch, ATOL)
        close(got, want, f"{arch} step {t} logits", atol)
        for (k, g), (_, w) in zip(leaves(tc), leaves(jc)):
            close(g, w, f"{arch} step {t} cache {k}", atol)


BLOCKS = {   # kind: (train form, decode form, decode cache, an arch using it)
    "slstm": ("slstm_apply", "slstm_apply", "init_slstm_cache",
              "xlstm-350m"),
    "mlstm": ("mlstm_train", "mlstm_decode", "init_mlstm_cache",
              "xlstm-350m"),
    "mamba": ("mamba_train", "mamba_decode", "init_mamba_cache",
              "jamba-v0.1-52b"),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_recurrent_blocks_match_jax(kind):
    """Each recurrent block alone, on the same inputs: its training form
    over S steps, then STEPS decode steps from an empty cache."""
    train, dec, init_cache, arch = BLOCKS[kind]
    jmod, tmod = (j_xlstm, xlstm) if kind != "mamba" else (j_ssm, ssm)
    cfg = smoke_config(arch)
    jp = jax.jit(lambda k: getattr(jmod, f"init_{kind}")(k, cfg))(
        init_key(7))
    tp = params_from_jax(jp, device="cpu")
    x = np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    first = lambda o: o[0] if isinstance(o, tuple) else o   # noqa: E731
    want = first(jax.jit(lambda p, x: getattr(jmod, train)(p, cfg, x))(
        jp, jnp.asarray(x)))
    close(first(getattr(tmod, train)(tp, cfg, torch.from_numpy(x))), want,
          kind)
    jc = getattr(jmod, init_cache)(cfg, B)
    tc = getattr(tmod, init_cache)(cfg, B, device="cpu")
    jstep = jax.jit(lambda p, x, c: getattr(jmod, dec)(p, cfg, x, c))
    for t in range(STEPS):
        want, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc = getattr(tmod, dec)(tp, cfg, torch.from_numpy(
            x[:, t:t + 1].copy()), tc)
        close(got, want, f"{kind} step {t}")
        for (k, g), (_, w) in zip(leaves(tc), leaves(jc)):
            close(g, w, f"{kind} step {t} cache {k}")


def test_port_init_has_the_reference_tree(arch_case):
    arch, jcfg, jp, _, _, _ = arch_case
    cfg = smoke_config(arch)
    tp = init_model(cfg, gen(1))
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in leaves(tp)] == \
        [(k, v.shape, f"torch.{v.dtype}") for k, v in leaves(jp)]
    # dense_init: a truncated normal at 2 std of scale / sqrt(fan_in)
    emb = tp["embed"]
    lim = 2.0 / cfg.vocab_size ** 0.5
    assert emb.abs().max() <= lim * (1 + 1e-6) and emb.std() > lim / 4


def test_params_checkpoint_across_packages(tmp_path, arch_case):
    """A checkpoint of either package's params restores in the other."""
    arch, jcfg, jp, tp, _, _ = arch_case
    j_save(str(tmp_path / "j"), 0, jp)
    got = restore_checkpoint(str(tmp_path / "j"), 0,
                             init_model(smoke_config(arch), gen(2)))
    for (k, g), (_, w) in zip(leaves(got), leaves(jp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
    save_checkpoint(str(tmp_path / "t"), 0, tp)
    back = j_restore(str(tmp_path / "t"), 0, jp)
    for (k, g), (_, w) in zip(leaves(back), leaves(jp)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# the port alone: train/decode agreement (tests/test_models.py)
# ---------------------------------------------------------------------------

S_EQ = 12


def _equiv_check(cfg, atol, max_len=None):
    params = init_model(cfg, gen(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, S_EQ), generator=gen(1))
    logits_train, _ = forward(params, cfg, {"inputs": tokens})
    cache = init_decode_cache(cfg, B, max_len or S_EQ, dtype=torch.float32,
                              device="cpu")
    outs = []
    for t in range(S_EQ):
        lg, cache = decode_step(params, cfg, tokens[:, t],
                                torch.full((B,), t, dtype=torch.int32),
                                cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               logits_train.numpy(), atol=atol,
                               err_msg=cfg.name)


EQUIV = {
    "dense": (dict(num_layers=2, qkv_bias=True, rope_fraction=0.5), 1e-4,
              None),
    # window smaller than the sequence: the ring cache must stay causal
    "ring_wraparound": (dict(num_layers=2, num_kv_heads=4,
                             sliding_window=4), 1e-4, 64),
    "moe": (dict(family="moe", num_layers=2, num_experts=4, top_k=2,
                 moe_pattern=(True,)), 1e-4, None),
    "hybrid": (dict(family="hybrid", num_layers=4, stage_period=4,
                    block_pattern=("mamba", "mamba", "attn", "mamba"),
                    moe_pattern=(False, True, False, True), num_experts=4,
                    top_k=2), 2e-4, None),
    "xlstm": (dict(family="ssm", num_layers=4, num_kv_heads=4, d_ff=0,
                   stage_period=4,
                   block_pattern=("slstm", "mlstm", "mlstm", "mlstm")),
              2e-4, None),
    "chunked_global": (dict(family="moe", num_layers=4, stage_period=4,
                            block_pattern=("attn",) * 4,
                            moe_pattern=(True,) * 4, num_experts=4, top_k=1,
                            chunk_attn=4, global_attn_slots=(3,)), 1e-4,
                       S_EQ),
}


@pytest.mark.parametrize("name", sorted(EQUIV))
def test_train_decode_equiv(name):
    kw, atol, max_len = EQUIV[name]
    base = dict(name=name, family="dense", d_model=32, num_heads=4,
                num_kv_heads=2, d_ff=64, vocab_size=61, dtype="float32")
    _equiv_check(ModelConfig(**{**base, **kw}), atol, max_len)


def test_mlstm_parallel_vs_recurrent():
    """The quadratic training form equals the O(1) recurrent form."""
    cfg = ModelConfig(name="x", family="ssm", num_layers=1, d_model=16,
                      num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=7,
                      block_pattern=("mlstm",), dtype="float32")
    p = init_mlstm(gen(0), cfg)
    x = torch.randn((B, S_EQ, 16), generator=gen(1))
    out_par = mlstm_train(p, cfg, x)
    cache = init_mlstm_cache(cfg, B, device="cpu")
    outs = []
    for t in range(S_EQ):
        o, cache = mlstm_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               out_par.numpy(), atol=1e-4)


def test_moe_matches_dense_expert_loop():
    """Ragged dispatch == an explicit per-expert float64 loop."""
    D, F, E, k = 16, 32, 4, 2
    p = init_moe(gen(0), D, F, E)
    x = torch.randn((2, 6, D), generator=gen(1))
    out, aux = moe_ffn(p, x, k)

    xf = x.double().reshape(-1, D).numpy()
    logits = xf @ p["router"].double().numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1)[:, :k]
    want = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        g = probs[t, top[t]]
        g = g / g.sum()
        for j, e in enumerate(top[t]):
            wg, wi, wo = (p[n][e].double().numpy() for n in ("wg", "wi", "wo"))
            gate = xf[t] @ wg
            h = gate / (1 + np.exp(-gate)) * (xf[t] @ wi)
            want[t] += g[j] * (h @ wo)
    np.testing.assert_allclose(out.reshape(-1, D).numpy(), want, atol=1e-4)
    assert float(aux) > 0


@pytest.mark.parametrize("D,F,E,k,shape,seed", [
    (16, 32, 8, 2, (2, 12), 0),           # test_moe_dispatch.py's cases
    (16, 32, 4, 1, (1, 8), 2),
])
def test_moe_dispatch_modes_match_each_other_and_jax(D, F, E, k, shape,
                                                      seed):
    jp = jax.jit(lambda k: j_init_moe(k, D, F, E))(init_key(seed))
    x = np.random.default_rng(seed).standard_normal(shape + (D,)).astype(
        np.float32)
    tp = params_from_jax(jp, device="cpu")
    out_r, aux_r = moe_ffn(tp, torch.from_numpy(x), k, dispatch="ragged")
    out_d, aux_d = moe_ffn(tp, torch.from_numpy(x), k, dispatch="dense")
    np.testing.assert_allclose(out_d.numpy(), out_r.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(aux_d), float(aux_r), rtol=1e-6)
    for mode, got, aux in (("ragged", out_r, aux_r), ("dense", out_d, aux_d)):
        want, want_aux = jax.jit(lambda p, x: j_moe_ffn(p, x, k, dispatch=mode)
                                 )(jp, jnp.asarray(x))
        close(got, want, mode)
        close(aux, want_aux, mode)
    with pytest.raises(ValueError):
        moe_ffn(tp, torch.from_numpy(x), k, dispatch="sparse")


def test_config_checks_raise():
    with pytest.raises(ValueError):
        ModelConfig(name="bad", family="dense", num_layers=3, d_model=8,
                    num_heads=2, num_kv_heads=2, d_ff=8, vocab_size=8,
                    stage_period=2, block_pattern=("attn", "attn"))
    with pytest.raises(ValueError):
        dataclasses.replace(smoke_config("jamba-v0.1-52b"),
                            moe_pattern=(True,))
