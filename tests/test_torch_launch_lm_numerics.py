"""The LM cells' functions on a real 2 × 2 mesh against the reference's.

Four gloo ranks on the CPU (one spawn for the module, whose ranks import
this file alone) build ``init_device_mesh("cpu", (2, 2), ("data",
"model"))`` and run the port's ``_build_train`` / ``_build_prefill`` /
``_build_decode`` cells, through ``build_cell``, on DTensors placed by
the cells' specs (``specs.place``), for qwen2-0.5b SMOKE and
mixtral-8x7b SMOKE (dense MoE dispatch), and qwen2-0.5b's train step
once more on a batch of 4, which the cell splits into 2 microbatches
(each rank's shard of 2 rows cut in two: a microbatch holds block i of
every shard, the reference's block i of the global batch, so the two
sum their gradients in another order).  The reference's same-named
builders run in this process while the ranks do, jitted on a 1 × 1
``jax.sharding.Mesh``, on the same inputs: params from its
``init_model``, moments drawn with numpy at step 10 (at step 0 AdamW
moves each weight by lr·g/(|g| + eps), about lr·sign(g): a gradient
that is rounding noise, as some are, would move it either way by the
same amount), token ids drawn with numpy, a cache from its
``init_decode_cache`` at position 5.  Compared (float32 SMOKE, rtol
1e-5 and atol 1e-6 unless said): the train step's loss, gradient norm
and updated params and moments; the last-position logits and the decode
logits, atol 1e-5 of the largest logit (the ranks' partial sums add in
another order than one device's products: 3e-6 on logits up to 2.4 for
mixtral's dense experts); the written cache (bfloat16: one unit in the
last place, 2^-7 relative).
"""

import copy
import dataclasses
import datetime
import functools
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, smoke_config

ARCHS = ("qwen2-0.5b", "mixtral-8x7b")
# the recurrences on local shards (``steps.on_shards``): mamba's scan and
# conv, the mLSTM's parallel form and step, the sLSTM's loop
RECURRENT = ("jamba-v0.1-52b", "xlstm-350m")
# those whose step on whole tensors already meets the file's limits
# against the reference, and so is held there directly too
JAX_DIRECT = ("jamba-v0.1-52b",)
# xlstm-350m's SMOKE stack at random init is ill-conditioned
# (test_torch_models.STACK_ATOL): the mesh run and the same function on
# whole tensors, summing in other orders, differ by up to 8.4e-5 relative
# in a second moment and 1.3e-5 of the largest decode logit, so its
# limits are the file's times this
LIMIT_SCALE = {"xlstm-350m": 10.0}
SMALL = {"train_4k": (8, 2), "prefill_32k": (8, 4), "decode_32k": (8, 4)}
# the microbatched train step: a batch of 4, 2 rows a data rank
MICRO = ("qwen2-0.5b", "train_4k", (8, 4))
POS = 5
STEP = 10       # the optimizer's step count going in
SPAWN_TIMEOUT_S = 240
CASES = [(a, n, SMALL[n]) for a in ARCHS for n in SMALL] + [MICRO] + [
    (a, n, SMALL[n]) for a in RECURRENT for n in ("train_4k", "decode_32k")]


def _key(arch, name, size):
    return arch, name + ("" if size == SMALL[name] else "_micro")


def _shape(name, size):
    S, B = size
    return dataclasses.replace(SHAPES[name], seq_len=S, global_batch=B)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _inputs(arch, name, size, params):
    """The cell's global inputs as numpy trees (``None`` where the cell
    takes none), from the reference's params."""
    rng = np.random.default_rng(7)
    cfg = smoke_config(arch)
    S, B = size
    if name == "decode_32k":
        tok = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        return (params, tok, np.full(B, POS, np.int32))
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if name == "prefill_32k":
        return (params, batch)
    batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)
    opt = {"step": np.array(STEP, np.int32),
           "mu": _moments(params, rng, lambda r, x: 1e-3 * r.standard_normal(
               x.shape)),
           "nu": _moments(params, rng, lambda r, x: r.uniform(
               1e-6, 1e-5, x.shape))}
    return (params, opt, None, batch)


def _moments(tree, rng, draw):
    """Moments of ``tree``'s shapes, float32, in sorted key order."""
    if isinstance(tree, dict):
        return {k: _moments(tree[k], rng, draw) for k in sorted(tree)}
    return draw(rng, tree).astype(np.float32)


# ------------------------------------------------------------- the ranks
def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    return torch.from_numpy(np.array(t, copy=True))


def _whole(t):
    """A result as numpy: DTensors gathered whole."""
    if isinstance(t, dict):
        return {k: _whole(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_whole(v) for v in t) if not hasattr(t, "_fields") \
            else {f: _whole(v) for f, v in zip(t._fields, t)}
    if t is None:
        return None
    if type(t).__name__ == "DTensor":
        t = t.full_tensor()
    return t.detach().float().numpy()


def _rank_job(rank, job):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.specs import build_cell, place
    from repro_torch.models.model import init_decode_cache
    from repro_torch.train.optim import OptState
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for (arch, name, size), vals in job["cases"].items():
        cell = build_cell(arch, name, mesh, cfg=smoke_config(arch),
                          shape=_shape(name, size))
        vals = list(vals)
        vals[0] = _torch_tree(vals[0])
        if name == "train_4k":
            o = vals[1]
            vals[1] = OptState(torch.from_numpy(o["step"]),
                               _torch_tree(o["mu"]), _torch_tree(o["nu"]))
            vals[3] = _torch_tree(vals[3])
        elif name == "prefill_32k":
            vals[1] = _torch_tree(vals[1])
        else:
            vals[1], vals[2] = (torch.from_numpy(v) for v in vals[1:])
            S, B = size
            vals.append(init_decode_cache(smoke_config(arch), B, S,
                                          device="cpu"))
        plain = copy.deepcopy(vals) if arch in RECURRENT and rank == 0 \
            else None
        args = place(tuple(vals), cell.specs, mesh)
        res = cell.fn(*args)
        out[_key(arch, name, size)] = {"res": _whole(res),
                                       "plan": cell.meta.get("plan")}
        if plain is not None:       # the same function on whole tensors
            out[_key(arch, name, size)]["plain"] = _whole(cell.fn(*plain))
    return out if rank == 0 else None


def _rank_main(rank, n, d):
    """One gloo rank: ``_rank_job`` on ``d/job.pkl``, its result to
    ``d/out_<rank>.pkl``."""
    import torch.distributed as dist
    d = Path(d)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    try:
        end = time.monotonic() + SPAWN_TIMEOUT_S
        while not (d / "job.pkl").exists() and time.monotonic() < end:
            time.sleep(0.05)
        out = _rank_job(rank, pickle.loads((d / "job.pkl").read_bytes()))
        (d / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def _spawn(n, d):
    """``n`` gloo ranks of ``_rank_main`` started (start method
    ``spawn``; each imports this file, not the reference); they wait for
    their job (``_post``)."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n, str(d)))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs


def _post(job, d):
    """The ranks' job, written whole before it is seen."""
    (d / "job.tmp").write_bytes(pickle.dumps(job))
    (d / "job.tmp").replace(d / "job.pkl")


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def _join(procs, d):
    """Rank 0's result once every rank ended; all are stopped at once if
    one fails."""
    end = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while (time.monotonic() < end and any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)):
            time.sleep(0.1)
    finally:
        _stop(procs)
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return pickle.loads((d / "out_0.pkl").read_bytes())


# ------------------------------------------------------------- the test
@pytest.fixture(scope="module")
def both(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as j_smoke
    from repro.launch import specs as js
    from repro.models import init_decode_cache as j_cache
    from repro.models import init_model as j_init
    from repro.train.optim import OptState as JOpt

    d = tmp_path_factory.mktemp("lm_numerics")
    procs = _spawn(4, d)            # they start while the inputs are drawn
    jcfgs, params, cases = {}, {}, {}
    try:
        for arch in ARCHS + RECURRENT:
            jcfgs[arch] = dataclasses.replace(j_smoke(arch),
                                              moe_dispatch="dense")
            params[arch] = _np_tree(jax.jit(functools.partial(
                j_init, jcfgs[arch]))(jax.random.key(11)))
        for arch, name, size in CASES:
            cases[arch, name, size] = _inputs(arch, name, size, params[arch])
        _post({"cases": cases}, d)
    except BaseException:
        _stop(procs)
        raise
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    want = {}
    try:
        for (arch, name, size), vals in cases.items():
            jcfg = jcfgs[arch]
            shape = _shape(name, size)
            jp = jax.tree.map(jnp.asarray, params[arch])
            key = _key(arch, name, size)
            with jmesh:
                if name == "train_4k":
                    plan = {"microbatches": size[1] // 2, "remat": "none",
                            "moment_dtype": "float32", "semi": False}
                    cell = js._build_train(arch, jcfg, shape, jmesh, plan)
                    o = vals[1]
                    opt = JOpt(jnp.asarray(o["step"]),
                               jax.tree.map(jnp.asarray, o["mu"]),
                               jax.tree.map(jnp.asarray, o["nu"]))
                    batch = jax.tree.map(jnp.asarray, vals[3])
                    p2, o2, _, m = jax.jit(cell.fn)(jp, opt, None, batch)
                    want[key] = (
                        _np_tree(p2), JOpt(*[_np_tree(x) for x in o2]),
                        {k: float(v) for k, v in m.items()})
                elif name == "prefill_32k":
                    cell = js._build_prefill(arch, jcfg, shape, jmesh)
                    want[key] = np.asarray(jax.jit(cell.fn)(
                        jp, jax.tree.map(jnp.asarray, vals[1])))
                else:
                    cell = js._build_decode(arch, jcfg, shape, jmesh)
                    cache = j_cache(jcfg, shape.global_batch, shape.seq_len)
                    logits, c2 = jax.jit(cell.fn)(
                        jp, jnp.asarray(vals[1]), jnp.asarray(vals[2]), cache)
                    want[key] = (np.asarray(logits),
                                 _np_tree(jax.tree.map(
                                     lambda a: a.astype(jnp.float32), c2)))
    finally:
        got = _join(procs, d)
    return got, want


def _close(a, b, **tol):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _close(a[k], b[k], **tol)
        return
    np.testing.assert_allclose(a, b, **tol)


def _check_train(got, want, key, microbatches):
    res = got[key]
    assert res["plan"]["microbatches"] == microbatches
    params, opt, _, metrics = res["res"]
    p_want, o_want, m_want = want[key]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k], m_want[k], rtol=1e-5)
    _close(params, p_want, rtol=1e-5, atol=1e-6)
    _close(opt["mu"], o_want.mu, rtol=1e-5, atol=1e-6)
    _close(opt["nu"], o_want.nu, rtol=1e-5, atol=1e-9)
    assert opt["step"] == STEP + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(both, arch):
    _check_train(*both, (arch, "train_4k"), 1)


def test_microbatched_train_step(both):
    """The train step over 2 microbatches of DTensor shards (block i of
    every rank's rows) against the reference's over 2 contiguous blocks
    of the batch: the same loss and update, at the same limits."""
    arch, name, size = MICRO
    _check_train(*both, _key(arch, name, size), 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits(both, arch):
    got, want = both
    w = want[arch, "prefill_32k"]
    _close(got[arch, "prefill_32k"]["res"], w, rtol=1e-5,
           atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_and_cache(both, arch):
    got, want = both
    logits, cache = got[arch, "decode_32k"]["res"]
    l_want, c_want = want[arch, "decode_32k"]
    _close(logits, l_want, rtol=1e-5, atol=1e-5 * np.abs(l_want).max())
    _close(cache, c_want, rtol=2.0 ** -7, atol=1e-6)
    # the step wrote position POS of every repeat's ring, nothing else
    k = cache["slot0"]["k"]
    assert np.abs(k[:, :, :, POS]).sum() > 0
    assert np.abs(np.delete(k, POS, axis=3)).sum() == 0


def _no_farther(got, plain, want, rtol, atol):
    """Entry by entry, |got - want| <= |plain - want| + atol + rtol |want|:
    the mesh run no farther from the reference than the same function on
    whole tensors is, but for the file's limits."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _no_farther(got[k], plain[k], want[k], rtol, atol)
        return
    got, plain, want = (np.asarray(x, np.float64) for x in (got, plain, want))
    excess = (np.abs(got - want) - np.abs(plain - want)
              - (atol + rtol * np.abs(want)))
    assert excess.max() <= 0, f"{excess.max():.3e} past the limit"


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_step(both, arch):
    """jamba's mamba and MoE layers and xlstm's mLSTM and sLSTM blocks
    trained on the 2 x 2 mesh (the recurrences on each rank's shard of
    the batch, and of mamba's channels and the mLSTM's heads where
    ``model`` divides them): against the same step on whole tensors at
    the file's limits, and against the reference's step no farther than
    that whole-tensor step is, but for the same limits; jamba's also
    directly at them (``JAX_DIRECT``)."""
    got, want = both
    key = (arch, "train_4k")
    f = LIMIT_SCALE.get(arch, 1.0)
    assert got[key]["plan"]["microbatches"] == 1
    params, opt, _, metrics = got[key]["res"]
    p_pl, o_pl, _, m_pl = got[key]["plain"]
    p_want, o_want, m_want = want[key]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k], m_pl[k], rtol=1e-5 * f)
        _no_farther(metrics[k], m_pl[k], m_want[k], 1e-5 * f, 0.0)
    for a, pl, w, atol in ((params, p_pl, p_want, 1e-6),
                           (opt["mu"], o_pl["mu"], o_want.mu, 1e-6),
                           (opt["nu"], o_pl["nu"], o_want.nu, 1e-9)):
        _close(a, pl, rtol=1e-5 * f, atol=atol * f)
        _no_farther(a, pl, w, 1e-5 * f, atol * f)
    if arch in JAX_DIRECT:
        _check_train(got, want, key, 1)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_logits_and_state(both, arch):
    """One decode step on the 2 x 2 mesh, the recurrent states updated on
    their shards: the logits and every cache leaf (the states, jamba's
    attention ring) against the same step on whole tensors and against
    the reference's (as ``test_recurrent_train_step``), at the file's
    limits."""
    got, want = both
    key = (arch, "decode_32k")
    f = LIMIT_SCALE.get(arch, 1.0)
    logits, cache = got[key]["res"]
    l_pl, c_pl = got[key]["plain"]
    l_want, c_want = want[key]
    atol = 1e-5 * f * np.abs(l_want).max()
    _close(logits, l_pl, rtol=1e-5 * f, atol=atol)
    _no_farther(logits, l_pl, l_want, 1e-5 * f, atol)
    _close(cache, c_pl, rtol=2.0 ** -7, atol=1e-6)
    _no_farther(cache, c_pl, c_want, 2.0 ** -7, 1e-6)
    if arch in JAX_DIRECT:
        _close(logits, l_want, rtol=1e-5, atol=1e-5 * np.abs(l_want).max())
        _close(cache, c_want, rtol=2.0 ** -7, atol=1e-6)
