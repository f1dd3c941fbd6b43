"""The port's training substrate against the reference's, on the CPU.

``optim``: the warmup-cosine schedule (bit for bit in the warmup; after
it within one float32 ulp: XLA's CPU ``cos`` and torch's differ by one
ulp on some inputs), ``global_norm`` and ``adamw_update`` (float32 and
bfloat16 moments); ``compress``: int8 quantization and error feedback,
bit for bit; ``models.loss_fn`` and every gradient leaf of every
registry arch's SMOKE config on the reference's params
(``params_from_jax``) at ``rtol=1e-4, atol=1e-5`` (xlstm-350m's stack at
its looser limit, hubert and llava fed embeddings); ``remat`` "full" and
"dots" equal to "none" bit for bit, and what "dots" recomputes counted;
one ``make_train_step`` step against the reference's; microbatch
accumulation against the full batch; the reference's 15-step
convergence cases (``tests/test_substrate.py``); ``derive_plan`` over a
sweep of batches and device counts.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import smoke_config as j_smoke_config
from repro.distributed.compress import compress_grads as j_compress_grads
from repro.distributed.compress import init_error_feedback as j_init_ef
from repro.distributed.compress import quantize_int8 as j_quantize_int8
from repro.models import ModelConfig as JModelConfig
from repro.models import init_model as j_init_model
from repro.models import loss_fn as j_loss_fn
from repro.train.elastic import derive_plan as j_derive_plan
from repro.train.optim import OptConfig as JOptConfig
from repro.train.optim import adamw_init as j_adamw_init
from repro.train.optim import adamw_update as j_adamw_update
from repro.train.optim import cosine_schedule as j_cosine_schedule
from repro.train.optim import global_norm as j_global_norm
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.distributed.compress import (compress_grads,
                                              dequantize_int8,
                                              init_error_feedback,
                                              quantize_int8)
from repro_torch.models import ModelConfig, init_model, loss_fn
from repro_torch.models import params_from_jax
from repro_torch.train.elastic import derive_plan
from repro_torch.train.optim import (OptConfig, OptState, adamw_init,
                                     adamw_update, cosine_schedule,
                                     global_norm, opt_state_from_jax,
                                     tree_leaves, tree_map)
from repro_torch.train.train_step import make_train_step, value_and_grad
from tests.test_torch_models import STACK_ATOL, init_key, leaves

RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 16
LM = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, d_ff=64, vocab_size=31, dtype="float32")
CFG, JCFG = ModelConfig(**LM), JModelConfig(**LM)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: with the
    suite's parallel workers, torch's default (a thread a core, each
    worker) oversubscribes the cores many times over; alone it is no
    faster at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tokens(bs=4, s=16, seed=1, vocab=31):
    """test_substrate's batch shape, drawn by numpy."""
    t = np.random.default_rng(seed).integers(0, vocab, (bs, s + 1)).astype(
        np.int32)
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_tree(got, want, what, rtol=RTOL, atol=ATOL):
    for (k, g), (_, w) in zip(leaves(got), leaves(want), strict=True):
        np.testing.assert_allclose(
            g.detach().float().numpy(), np.asarray(w, np.float32),
            rtol=rtol, atol=atol, err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr,warm,total", [(3e-4, 10, 40), (1e-2, 2, 40),
                                           (3e-3, 10, 200),
                                           (3e-4, 100, 10_000)])
def test_cosine_schedule_matches_jax(lr, warm, total):
    """The warmup bit for bit.  After it, XLA's CPU ``cos`` and torch's
    differ by one ulp on some inputs, and ``min + 0.45 * (1 + cos)``
    turns that into at most 0.45 * 2^-24 of a factor >= 0.1: within
    5e-7 of the rate (5 ulps where ``1 + cos`` cancels near the end)."""
    steps = np.arange(0, total + 20, dtype=np.int32)
    jc, tc = JOptConfig(lr=lr, warmup_steps=warm, total_steps=total), \
        OptConfig(lr=lr, warmup_steps=warm, total_steps=total)
    want = np.asarray(jax.vmap(lambda s: j_cosine_schedule(jc, s))(
        jnp.asarray(steps)))
    got = cosine_schedule(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got[:warm], want[:warm])
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


@functools.lru_cache(maxsize=1)
def _jinit():
    return jax.jit(lambda k: j_init_model(JCFG, k))


def j_params(seed=0):
    """The reference's ``init_model(JCFG)`` (jitted once: its eager init
    dispatches op by op)."""
    return _jinit()(jax.random.key(seed))


def _shapes():
    return jax.eval_shape(j_params)


def _grad_tree(seed, scale=1.0):
    """A params-shaped tree of numpy gradients (CFG's tree)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), _shapes())


def test_global_norm_matches_jax():
    """Leaves in the reference's order (sorted keys); each leaf's sum of
    squares is one long float32 sum, which XLA's CPU reduction groups
    its own way (143.29977 against 143.29974 on ``_grad_tree(11)``), so
    the norm is held at rtol 1e-6, not bit for bit."""
    for seed in range(3, 13):
        g = _grad_tree(seed)
        np.testing.assert_allclose(
            float(global_norm(params_from_jax(g, device="cpu"))),
            float(j_global_norm(g)), rtol=1e-6)
    assert [k for k, _ in leaves(g)] == sorted(k for k, _ in leaves(g))
    assert len(tree_leaves(params_from_jax(g, device="cpu"))) == \
        len(jax.tree.leaves(g))


def _adam_pair(moment_dtype):
    jc = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                    moment_dtype=moment_dtype)
    jp = j_params()
    tp = params_from_jax(jp, device="cpu")
    tc = OptConfig(**dataclasses.asdict(jc))
    return jc, jp, j_adamw_init(jp, jc), tc, tp, adamw_init(tp, tc)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    """Three updates on equal params, grads and state, each below the
    clip norm (scale exactly 1): moments bit for bit; params at rtol
    1e-6 and atol 1e-8 (1e-6 of the rate: ``b ** step`` is a float32
    power in both, which XLA and torch may round an ulp apart)."""
    jc, jp, js, tc, tp, ts = _adam_pair(moment_dtype)
    assert ts.step.dtype == torch.int32
    assert all(t.dtype == getattr(torch, moment_dtype)
               for t in tree_leaves(ts.mu) + tree_leaves(ts.nu))
    for i, scale in enumerate((1e-3, 5e-3, 3e-3)):
        g = _grad_tree(10 + i, scale)
        jp, js, jm = j_adamw_update(jp, g, js, jc)
        before = tree_leaves(tp)
        tp, ts, tm = adamw_update(tp, params_from_jax(g, device="cpu"), ts,
                                  tc)
        assert all(a is b for a, b in zip(tree_leaves(tp), before))  # in place
        assert int(ts.step) == int(js.step) == i + 1
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(jm["grad_norm"]) < jc.clip_norm
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        check_tree(tp, jp, f"step {i} params", rtol=1e-6, atol=1e-8)
        for name in ("mu", "nu"):
            check_tree(getattr(ts, name), getattr(js, name),
                       f"step {i} {name}", rtol=0, atol=0)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_clips_like_jax(moment_dtype):
    """One update past the clip norm: the scale is clip / norm, and the
    norms may be ulps apart (``test_global_norm_matches_jax``), so the
    moments hold at rtol 1e-6 in float32 and within one bfloat16 step
    (2^-7 of the value at most) when stored in bfloat16."""
    jc, jp, js, tc, tp, ts = _adam_pair(moment_dtype)
    g = _grad_tree(11)
    jp, js, jm = j_adamw_update(jp, g, js, jc)
    tp, ts, tm = adamw_update(tp, params_from_jax(g, device="cpu"), ts, tc)
    assert float(jm["grad_norm"]) > 10 * jc.clip_norm
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    check_tree(tp, jp, "params", rtol=1e-6, atol=1e-8)
    rtol = 1e-6 if moment_dtype == "float32" else 2.0 ** -7
    check_tree(ts.mu, js.mu, "mu", rtol=rtol, atol=0)
    check_tree(ts.nu, js.nu, "nu", rtol=2 * rtol, atol=0)


def test_opt_state_from_jax_keeps_dtypes():
    jc = JOptConfig(moment_dtype="bfloat16")
    jp = j_params()
    js = j_adamw_init(jp, jc)
    _, js, _ = j_adamw_update(jp, jax.tree.map(jnp.ones_like, jp), js, jc)
    ts = opt_state_from_jax(js, device="cpu")
    assert isinstance(ts, OptState) and ts.step.dtype == torch.int32
    assert int(ts.step) == 1
    for (k, t), (_, a) in zip(leaves(ts.mu), leaves(js.mu), strict=True):
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(a).view(np.int16), err_msg=k)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal(4096).astype(np.float32) * 3,
              # exact halves of the step: round half to even in both
              (np.arange(-600, 601, dtype=np.float32) * 0.5)[None],
              np.zeros((3, 5), np.float32)):
        jq, js = j_quantize_int8(jnp.asarray(x))
        q, s = quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        err = (dequantize_int8(q, s) - torch.from_numpy(x)).abs().max()
        amax = float(np.abs(x).max())
        assert float(err) <= float(s) * 0.5 + amax * 2.0 ** -23


def test_compress_grads_matches_jax():
    jef = j_init_ef(_grad_tree(0))
    tef = init_error_feedback(params_from_jax(_grad_tree(0), device="cpu"))
    for i in range(3):
        g = _grad_tree(20 + i)
        jg, jef = j_compress_grads(g, jef)
        tg, tef = compress_grads(params_from_jax(g, device="cpu"), tef)
        check_tree(tg, jg, f"step {i} grads", rtol=0, atol=0)
        check_tree(tef, jef, f"step {i} feedback", rtol=0, atol=0)
    same, ef = compress_grads({"w": torch.ones(3)}, None, enabled=False)
    assert ef is None and same["w"].eq(1).all()


def test_error_feedback_mean_converges():
    g = {"w": torch.full((8,), 0.3)}
    ef = init_error_feedback(g)
    total = torch.zeros(8)
    for _ in range(50):
        gq, ef = compress_grads(g, ef)
        total = total + gq["w"]
    np.testing.assert_allclose(total.numpy() / 50, 0.3, rtol=0.02)


# ---------------------------------------------------------------------------
# loss and gradients of every SMOKE arch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def grad_case(request):
    """One SMOKE arch: the reference's params, a batch (a few targets
    masked with -1; embeddings for frontend archs) and the reference's
    loss, metrics and gradients, jitted once."""
    arch = request.param
    i = ARCHS.index(arch)
    jcfg = j_smoke_config(arch)
    jp = jax.jit(lambda k: j_init_model(jcfg, k))(init_key(i))
    rng = np.random.default_rng(50 + i)
    batch = tokens(B, S, seed=50 + i, vocab=jcfg.vocab_size)
    batch["targets"][0, :3] = -1
    if jcfg.frontend != "none":
        batch["embeddings"] = rng.standard_normal(
            (B, S, jcfg.d_model)).astype(np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, b), has_aux=True))(jp, to_jax(batch))
    return arch, jp, batch, jl, jm, jg


def test_loss_and_grads_match_jax(grad_case):
    arch, jp, batch, jl, jm, jg = grad_case
    cfg = smoke_config(arch)
    tp = params_from_jax(jp, device="cpu")
    with torch.autograd.set_detect_anomaly(True):
        loss, m, grads = value_and_grad(tp, cfg, to_torch(batch),
                                        remat="none")
    atol = STACK_ATOL.get(arch, ATOL)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=atol)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                   atol=atol, err_msg=f"{arch} {k}")
    assert float(m["tokens"]) == B * S - 3
    check_tree(grads, jg, f"{arch} grad", atol=atol)
    # loss_fn itself, outside the train step
    l2, _ = loss_fn(tp, cfg, to_torch(batch))
    assert float(l2) == float(loss)


def test_remat_equals_none(grad_case):
    """Recomputing a stage (all of it, or all but its 2-D products)
    repeats the same float ops: bit for bit on the CPU."""
    arch, jp, batch, *_ = grad_case
    cfg = smoke_config(arch)
    tp = params_from_jax(jp, device="cpu")
    base = value_and_grad(tp, cfg, to_torch(batch), remat="none")
    for remat in ("full", "dots"):
        got = value_and_grad(tp, cfg, to_torch(batch), remat=remat)
        assert float(got[0]) == float(base[0]), (arch, remat)
        for (k, a), (_, b) in zip(leaves(got[2]), leaves(base[2])):
            assert torch.equal(a, b), (arch, remat, k)


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(cfg, params, batch, remat):
    """aten calls of one backward pass: what it recomputes shows here."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = loss_fn(tracked, cfg, batch, remat=remat)
    with OpCount() as c:
        torch.autograd.grad(loss, tree_leaves(tracked))
    return c.n


def test_dots_policy_saves_the_2d_products_only():
    """``dots`` recomputes the attention's batched products (``bmm``) and
    keeps every 2-D product (``mm``); ``full`` recomputes both.  A
    non-reentrant checkpoint stops recomputing once the tensors the
    backward saved are back, so each stage's last product (the MLP's
    down projection, whose output nothing saves) is not re-run."""
    cfg = smoke_config("qwen2-0.5b")
    params = init_model(cfg, torch.Generator().manual_seed(0))
    batch = to_torch(tokens(B, S, vocab=cfg.vocab_size))
    with OpCount() as fwd:
        loss_fn(params, cfg, batch)
    mm, bmm = fwd.n["mm"], fwd.n["bmm"]
    stage_mm = mm - 1                       # the head's product is outside
    none = _backward_ops(cfg, params, batch, "none")
    dots = _backward_ops(cfg, params, batch, "dots")
    full = _backward_ops(cfg, params, batch, "full")
    assert stage_mm == 7 * cfg.num_layers and bmm == 2 * cfg.num_layers
    assert dots["mm"] == none["mm"] and dots["bmm"] == none["bmm"] + bmm
    assert full["mm"] == none["mm"] + stage_mm - cfg.num_layers
    assert full["bmm"] == none["bmm"] + bmm
    with pytest.raises(ValueError):
        loss_fn(params, cfg, batch, remat="some")


def test_mamba_chunks_run_under_checkpoint():
    """A 128-step sequence crosses two mamba chunks of 64 steps: the
    backward pass re-runs each chunk's discretisation (an ``exp`` a step
    and a mamba layer; a plain backward of ``exp`` reuses its output)
    and gives the loss and grads of a run with grad disabled."""
    cfg = smoke_config("jamba-v0.1-52b")
    params = init_model(cfg, torch.Generator().manual_seed(3))
    batch = to_torch(tokens(1, 128, seed=4, vocab=cfg.vocab_size))
    n_mamba = cfg.block_pattern.count("mamba") * cfg.repeats
    ops = _backward_ops(cfg, params, batch, "none")
    assert ops["exp"] >= 128 * n_mamba
    loss, _, grads = value_and_grad(params, cfg, batch, remat="none")
    with torch.no_grad():
        l_ng, _ = loss_fn(params, cfg, batch)
    assert float(l_ng) == float(loss)
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_train_step_matches_jax():
    """Two steps at rtol 1e-5.  The gradients agree to atol 1e-5
    (``test_loss_and_grads_match_jax``), so the moments hold at that
    atol times (1 - b1) for mu and (1 - b2) * 2 max|g| for nu; params
    at atol 1e-5 (1e-3 of the rate): Adam's first steps divide each
    gradient by its own size, and a gradient that is a sum that cancels
    (8.70e-7 against 8.79e-7 in ``mlp/wi``) moves its param by the rate
    times a ratio ~1e-4 apart."""
    jc = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=40)
    tc = OptConfig(**dataclasses.asdict(jc))
    jp = j_params()
    tp = params_from_jax(jp, device="cpu")
    js, ts = j_adamw_init(jp, jc), adamw_init(tp, tc)
    jstep = jax.jit(j_make_train_step(JCFG, jc, remat="dots"))
    tstep = make_train_step(CFG, tc, remat="dots")
    for i in range(2):
        batch = tokens(seed=1 + i)
        jp, js, _, jm = jstep(jp, js, None, to_jax(batch))
        tp, ts, ef, tm = tstep(tp, ts, None, to_torch(batch))
        assert ef is None
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss",
                                            "lr", "tokens"]
        for k in tm:
            assert isinstance(tm[k], torch.Tensor)
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        check_tree(tp, jp, f"step {i} params", rtol=1e-5, atol=1e-5)
        check_tree(ts.mu, js.mu, f"step {i} mu", rtol=1e-5, atol=1e-6)
        check_tree(ts.nu, js.nu, f"step {i} nu", rtol=1e-5, atol=1e-7)


MOE = "mixtral-8x7b"


@pytest.mark.parametrize("arch", ["dense", MOE])
def test_grad_accumulation_matches_full_batch(arch):
    """Accumulated microbatch grads == full-batch grads (pre-optimizer),
    and the accumulating step reports the reference's metrics.  The MoE
    arch runs with ``router_aux_coef=0``: its aux loss is each call's
    routing statistic, while the cross entropy is a mean over equal
    microbatches."""
    cfg = CFG if arch == "dense" else dataclasses.replace(
        smoke_config(arch), router_aux_coef=0.0)
    params = init_model(cfg, torch.Generator().manual_seed(0))
    batch = to_torch(tokens(bs=8, vocab=cfg.vocab_size))
    l_full, _, g_full = value_and_grad(params, cfg, batch, remat="none")
    l_acc, m_acc, g_acc = value_and_grad(params, cfg, batch, remat="none",
                                         microbatches=4)
    assert m_acc == {}
    np.testing.assert_allclose(float(l_acc), float(l_full), rtol=1e-5)
    for (k, a), (_, b) in zip(leaves(g_acc), leaves(g_full), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=k)
    oc = OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    s4 = make_train_step(cfg, oc, remat="none", microbatches=4)
    _, _, _, m4 = s4(tree_map(torch.clone, params),
                     adamw_init(params, oc), None, batch)
    assert sorted(m4) == ["grad_norm", "loss", "lr"]
    np.testing.assert_allclose(float(m4["loss"]), float(l_full), rtol=1e-5)
    with pytest.raises(ValueError):
        value_and_grad(params, cfg, to_torch(tokens(bs=6)), microbatches=4)


def test_moe_microbatches_match_jax():
    """The ragged MoE under ``microbatches=2``: one step against the
    reference's microbatched step on its params (the aux loss is each
    microbatch's own routing statistic in both packages): metrics at
    rtol 1e-5, and the moments, which after one step are the accumulated
    gradients themselves (mu = (1 - b1) g, nu = (1 - b2) g^2), at
    ``test_train_step_matches_jax``'s limits.  The params are not held
    here: Adam's first step divides each gradient by its own size, and
    a gradient that is a sum cancelling to ~eps (a ``head`` entry's mu
    7.24e-10 against 7.07e-10) moves its param by the rate times ratios
    2 % apart; ``test_adamw_update_matches_jax`` holds the update
    itself."""
    jcfg, cfg = j_smoke_config(MOE), smoke_config(MOE)
    jp = jax.jit(lambda k: j_init_model(jcfg, k))(
        init_key(ARCHS.index(MOE)))
    tp = params_from_jax(jp, device="cpu")
    jc = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=40)
    tc = OptConfig(**dataclasses.asdict(jc))
    batch = tokens(4, S, seed=60, vocab=jcfg.vocab_size)
    jstep = jax.jit(j_make_train_step(jcfg, jc, remat="none",
                                      microbatches=2))
    _, js, _, jm = jstep(jp, j_adamw_init(jp, jc), None, to_jax(batch))
    tstep = make_train_step(cfg, tc, remat="none", microbatches=2)
    _, ts, _, tm = tstep(tp, adamw_init(tp, tc), None, to_torch(batch))
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr"]
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    check_tree(ts.mu, js.mu, "mu", rtol=1e-5, atol=1e-6)
    check_tree(ts.nu, js.nu, "nu", rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("moment_dtype,compress", [
    ("float32", False), ("bfloat16", False), ("float32", True)])
def test_train_loop_converges(moment_dtype, compress):
    """test_substrate.py's 15-step cases (both moment dtypes, and with
    compression), on the port's own init."""
    params = init_model(CFG, torch.Generator().manual_seed(0))
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=40,
                   moment_dtype=moment_dtype)
    opt = adamw_init(params, oc)
    ef = init_error_feedback(params) if compress else None
    step = make_train_step(CFG, oc, remat="none", compress=compress)
    batch = to_torch(tokens())
    losses = []
    for _ in range(15):
        params, opt, ef, m = step(params, opt, ef, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    if compress:
        assert all(torch.isfinite(e).all() for e in tree_leaves(ef))


# ---------------------------------------------------------------------------
# elastic plan
# ---------------------------------------------------------------------------

def test_derive_plan_matches_jax():
    for gb in (1, 7, 16, 100, 256, 4096):
        for n in (1, 2, 3, 8, 48, 64, 256, 512):
            for mp in (1, 8, 16):
                for mpd in (1, 4, 16):
                    got = derive_plan(gb, model_parallel=mp,
                                      devices=list(range(n)),
                                      max_per_device_batch=mpd)
                    want = j_derive_plan(gb, model_parallel=mp,
                                         devices=list(range(n)),
                                         max_per_device_batch=mpd)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (gb, n, mp, mpd)


def test_derive_plan_counts_the_cards():
    if torch.cuda.is_available():
        assert derive_plan(8).num_devices == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError):
            derive_plan(8)
