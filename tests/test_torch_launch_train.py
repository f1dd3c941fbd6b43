"""The port's training driver, checkpoints across packages, sharding rules.

``launch.train.main`` at ``examples/train_walk_lm.py``'s sizes, cut to a
few steps, with ``--device cpu``: it trains, checkpoints, and resumes
from the latest step (the restored tree equal to the saved one bit for
bit); without ``--device`` it wants the card.  A ``{"params", "opt"}``
checkpoint written by the reference's ``save_checkpoint``, bfloat16
moments included, restores into the port's tree bit for bit and the
port's next step equals the reference's; the other way round, the
port's files are the reference's byte for byte and the reference's
next step from them equals the port's.  (The reference's own
``restore_checkpoint`` cannot read a bfloat16 leaf: numpy has no cast
from its ``'<V2'`` files, "No cast function available"; its bfloat16
leaves are read here by viewing the bits.)  ``sharding``'s specs equal
the reference's for all ten archs at FULL shapes on 16 x 16 and
2 x 16 x 16 meshes, and ``placements`` gives each spec's shard shape and
is what ``distribute_tensor`` takes.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Shard

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.distributed.sharding import batch_pspec as j_batch_pspec
from repro.distributed.sharding import cache_pspecs as j_cache_pspecs
from repro.distributed.sharding import param_pspecs as j_param_pspecs
from repro.models import init_decode_cache as j_init_decode_cache
from repro.models import init_model as j_init_model
from repro.train.checkpoint import restore_checkpoint as j_restore
from repro.train.checkpoint import save_checkpoint as j_save
from repro.train.optim import OptConfig as JOptConfig
from repro.train.optim import OptState as JOptState
from repro.train.optim import adamw_init as j_adamw_init
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optim import OptConfig, adamw_init, opt_state_from_jax
from repro_torch.train.train_step import make_train_step
from tests.test_torch_models import leaves
from tests.test_torch_train import (CFG, JCFG, check_tree, j_params,  # noqa: F401
                                    one_torch_thread, to_jax, to_torch,
                                    tokens)

# examples/train_walk_lm.py's arguments
EXAMPLE = ["--steps", "200", "--scale", "10", "--d-model", "128",
           "--layers", "4", "--seq-len", "64", "--batch", "8"]


def tree_equal(a, b):
    for (k, x), (_, y) in zip(leaves(a), leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def state_tree(tree):
    """``{"params": ..., "opt": OptState}`` as nested dicts for ``leaves``."""
    opt = tree["opt"]
    return {"params": tree["params"],
            "opt": {".step": opt.step, ".mu": opt.mu, ".nu": opt.nu}}


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_train_driver_trains_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = EXAMPLE + ["--ckpt-dir", d, "--device", "cpu"]
    first = launch_train.main(argv + ["--steps", "12", "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss " in out and "[train] step 10 loss " in out
    assert "[train] done: 12 steps, final loss " in out
    assert first["start"] == 0 and len(first["losses"]) == 12
    losses = [float(x) for x in first["losses"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 1.0, losses
    assert latest_step(d) == 12
    assert sorted(os.listdir(d)) == ["step_10", "step_12"]      # keep=2
    saved = restore_checkpoint(d, 12, {"params": first["params"],
                                       "opt": first["opt"]})
    tree_equal(state_tree(saved), state_tree(first))
    assert int(saved["opt"].step) == 12
    second = launch_train.main(argv + ["--steps", "14"])
    out = capsys.readouterr().out
    assert "[train] restoring from step 12" in out
    assert second["start"] == 12 and len(second["losses"]) == 2
    assert int(second["opt"].step) == 14


def test_train_driver_with_an_arch(tmp_path, capsys):
    out = launch_train.main(["--arch", "qwen2-0.5b", "--steps", "2",
                             "--scale", "10", "--seq-len", "32", "--batch",
                             "2", "--ckpt-dir", str(tmp_path), "--device",
                             "cpu"])
    assert out["params"]["embed"].shape[0] == (1 << 10) + 1   # walk vocab
    assert len(out["losses"]) == 2
    assert "[train] done: 2 steps" in capsys.readouterr().out


def test_train_driver_checkpoints_under_its_checkout_by_default():
    """The default ``--ckpt-dir`` is this checkout's gitignored
    ``build/train_ckpt``: not the reference launcher's ``/tmp/repro_ckpt``,
    so neither package resumes from a run of the other's."""
    import inspect
    from pathlib import Path

    from repro.launch import train as j_launch_train
    root = Path(__file__).resolve().parents[1]
    assert Path(launch_train.DEFAULT_CKPT_DIR) == root / "build" / "train_ckpt"
    assert "/tmp/repro_ckpt" in inspect.getsource(j_launch_train.main)
    assert launch_train.DEFAULT_CKPT_DIR != "/tmp/repro_ckpt"


def test_train_driver_says_when_the_checkpoint_is_past_steps(tmp_path, capsys):
    argv = ["--steps", "2", "--scale", "10", "--seq-len", "16", "--batch",
            "2", "--d-model", "32", "--layers", "1", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    launch_train.main(argv)
    capsys.readouterr()
    again = launch_train.main(argv)
    out = capsys.readouterr().out
    assert "[train] restoring from step 2" in out
    assert "[train] nothing to train: step 2 >= --steps 2" in out
    assert again["start"] == 2 and again["losses"] == []


def test_train_driver_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises((RuntimeError, AssertionError)):
        launch_train.main(["--steps", "1", "--scale", "6",
                           "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _jax_trained(moment_dtype, steps=2):
    jc = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=40,
                    moment_dtype=moment_dtype)
    jp = j_params()
    js = j_adamw_init(jp, jc)
    step = jax.jit(j_make_train_step(JCFG, jc, remat="none"))
    for i in range(steps):
        jp, js, _, _ = step(jp, js, None, to_jax(tokens(seed=1 + i)))
    return jc, step, {"params": jp, "opt": js}


def _port_like(tc, seed=5):
    from repro_torch.models import init_model
    p = init_model(CFG, torch.Generator().manual_seed(seed))
    return {"params": p, "opt": adamw_init(p, tc)}


def _bits(a):
    """A JAX leaf as comparable numpy (bfloat16 as its int16 bits)."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _jax_tree(tree):
    """The port's {"params", "opt"} as the reference's tree."""
    opt = tree["opt"]
    to = lambda x: jnp.asarray(_as_numpy(x))                # noqa: E731
    return {"params": jax.tree.map(to, tree["params"]),
            "opt": JOptState(step=to(opt.step),
                             mu=jax.tree.map(to, opt.mu),
                             nu=jax.tree.map(to, opt.nu))}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_continues_in_the_port(tmp_path, moment_dtype):
    jc, jstep, jtree = _jax_trained(moment_dtype)
    j_save(str(tmp_path), 2, jtree)
    tc = OptConfig(**dataclasses.asdict(jc))
    got = restore_checkpoint(str(tmp_path), 2, _port_like(tc))
    for (k, t), (_, a) in zip(leaves(state_tree(got)),
                              leaves(state_tree(jtree)), strict=True):
        assert str(t.dtype) == f"torch.{np.asarray(a).dtype}", k
        np.testing.assert_array_equal(_bits(_as_numpy(t)), _bits(a),
                                      err_msg=k)
    direct = opt_state_from_jax(jtree["opt"], device="cpu")
    tree_equal(state_tree({"params": got["params"], "opt": direct}),
               state_tree(got))
    batch = tokens(seed=9)
    jp, js, _, jm = jstep(jtree["params"], jtree["opt"], None, to_jax(batch))
    tp, ts, _, tm = make_train_step(CFG, tc, remat="none")(
        got["params"], got["opt"], None, to_torch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    check_tree(tp, jp, "params", rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_port_checkpoint_continues_in_jax(tmp_path, moment_dtype):
    tc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=40,
                   moment_dtype=moment_dtype)
    tree = _port_like(tc, seed=0)
    step = make_train_step(CFG, tc, remat="none")
    for i in range(2):
        p, o, _, _ = step(tree["params"], tree["opt"], None,
                          to_torch(tokens(seed=1 + i)))
        tree = {"params": p, "opt": o}
    save_checkpoint(str(tmp_path / "t"), 2, tree)
    # the reference's writer on the same tree: the same files, byte for byte
    jtree = _jax_tree(tree)
    j_save(str(tmp_path / "j"), 2, jtree)
    tdir, jdir = tmp_path / "t" / "step_2", tmp_path / "j" / "step_2"
    mt = json.loads((tdir / "manifest.json").read_text())
    assert mt == json.loads((jdir / "manifest.json").read_text())
    for meta in mt["leaves"].values():
        assert (tdir / meta["file"]).read_bytes() == \
            (jdir / meta["file"]).read_bytes(), meta
    if moment_dtype == "float32":
        back = j_restore(str(tmp_path / "t"), 2, jtree)
    else:
        with pytest.raises(ValueError, match="No cast function"):
            j_restore(str(tmp_path / "j"), 2, jtree)
        back = _jax_read(tdir, jtree)
    for (k, a), (_, b) in zip(leaves(state_tree(back)),
                              leaves(state_tree(jtree)), strict=True):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
    jc = JOptConfig(**dataclasses.asdict(tc))
    batch = tokens(seed=9)
    jp, _, _, jm = jax.jit(j_make_train_step(JCFG, jc, remat="none"))(
        back["params"], back["opt"], None, to_jax(batch))
    tp, _, _, tm = step(tree["params"], tree["opt"], None, to_torch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    check_tree(tp, jp, "params", rtol=1e-5, atol=1e-5)


def _jax_read(d, like):
    """A checkpoint read as the reference reads it, but a bfloat16 leaf's
    bits viewed as ``jnp.bfloat16`` (where its ``restore_checkpoint``
    raises)."""
    mt = json.loads((d / "manifest.json").read_text())
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    arrs = []
    for path, _ in paths:
        meta = mt["leaves"]["/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)]
        a = np.load(d / meta["file"])
        if meta["dtype"] == "bfloat16":
            a = a.view(jnp.bfloat16)
        arrs.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, arrs)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _meta(tree):
    """The port's tree of meta tensors for a reference ShapeDtypeStruct
    tree (the same keys)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=getattr(torch, str(tree.dtype)),
                       device="meta")


def _spec_pairs(jspecs, tspecs):
    for (k, j), (_, t) in zip(leaves(jspecs), leaves(tspecs), strict=True):
        yield k, tuple(j), t


@pytest.fixture(scope="module")
def full_shapes():
    """Every arch's FULL params and two decode caches, as shapes only."""
    out = {}
    for arch in J_ARCHS:
        cfg = j_get_config(arch)
        params = jax.eval_shape(lambda k: j_init_model(cfg, k),
                                jax.random.key(0))
        caches = [jax.eval_shape(lambda b=b: j_init_decode_cache(cfg, b, 4096))
                  for b in (1, 128)]
        out[arch] = (cfg, params, caches)
    return out


def _local_shape(shape, placements, mesh):
    sizes = list(mesh.shape.values())
    local = list(shape)
    for size, p in zip(sizes, placements):
        if isinstance(p, Shard):
            assert local[p.dim] % size == 0
            local[p.dim] //= size
    return tuple(local)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_specs_match_jax_at_full_shapes(full_shapes, mesh_name):
    mesh = MESHES[mesh_name]
    for arch, (jcfg, jparams, jcaches) in full_shapes.items():
        cfg = get_config(arch)
        tparams = _meta(jparams)
        jspecs = j_param_pspecs(jparams, jcfg, mesh)
        tspecs = sharding.param_pspecs(tparams, cfg, mesh)
        n = 0
        for k, j, t in _spec_pairs(jspecs, tspecs):
            assert j == t, (arch, k, j, t)
            shape = leaf_shape(jparams, k)
            pl = sharding.placements(t, mesh)
            assert len(pl) == len(mesh.axis_names)
            assert _local_shape(shape, pl, mesh) == \
                NamedSharding(mesh, jax.sharding.PartitionSpec(*j)
                              ).shard_shape(shape), (arch, k)
            n += 1
        assert n == len(jax.tree.leaves(jparams))
        for jc in jcaches:
            for k, j, t in _spec_pairs(j_cache_pspecs(jcfg, mesh, jc),
                                       sharding.cache_pspecs(cfg, mesh,
                                                             _meta(jc))):
                assert j == t, (arch, "cache", k, j, t)
    for b in (1, 2, 16, 32, 100, 256, 512):
        jb = {"inputs": jax.ShapeDtypeStruct((b, 128), jnp.int32),
              "embeddings": jax.ShapeDtypeStruct((b, 128, 64), jnp.float32)}
        for k, j, t in _spec_pairs(j_batch_pspec(None, mesh, jb),
                                   sharding.batch_pspec(None, mesh,
                                                        _meta(jb))):
            assert j == t, (b, k, j, t)


def leaf_shape(tree, key):
    for part in key.strip("/").split("/"):
        tree = tree[part]
    return tuple(tree.shape)


def test_specs_read_a_device_mesh_and_feed_distribute_tensor(tmp_path):
    """A ``DeviceMesh`` (``mesh_dim_names``) reads as the reference's mesh;
    ``distribute_tensor`` takes ``placements`` on a one-rank world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    class Fake:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    assert sharding.fsdp_axes(Fake()) == ("pod", "data")
    assert sharding.axis_size(Fake(), ("pod", "data")) == 32
    assert sharding.placements((("pod", "data"), None, "model"), Fake()) == \
        [Shard(0), Shard(0), Shard(2)]
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), Fake())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("qwen2-0.5b")
        w = torch.randn(3, 64, 32)
        spec = sharding.param_pspecs({"stages": {"slot0": {"mlp": {
            "wg": w}}}}, cfg, mesh)["stages"]["slot0"]["mlp"]["wg"]
        assert spec == (None, "data", "model")
        pl = sharding.placements(spec, mesh)
        assert pl == [Shard(1), Shard(2)]
        dt = distribute_tensor(w, mesh, pl)
        assert tuple(dt.placements) == tuple(pl)
        assert torch.equal(dt.to_local(), w) and torch.equal(dt.full_tensor(),
                                                             w)
        assert sharding.placements((None, None), mesh) == [Replicate()] * 2
    finally:
        dist.destroy_process_group()
