"""The dry run's LM cells on a fake world of 256 ranks (16 × 16).

Every SMOKE arch × shape of ``CELLS`` (skipped as ``CELLS`` says; the
dense archs here, the MoE and recurrent ones in
``test_torch_launch_lm_cells_mixed.py`` through these checks) runs
on small shapes (``SMALL``: the sequence and the global batch cut,
every sharded dim still dividing) as rank 0 of the fake world.  Each
rank's argument bytes equal the sum of its local shard bytes computed on
the reference's side: ``jax.eval_shape`` of ``init_model`` /
``adamw_init`` / ``init_decode_cache`` and the reference's batch, laid
out by its ``param_pspecs`` / ``batch_pspec`` / ``cache_pspecs`` as
``NamedSharding.shard_shape`` splits them on an ``AbstractMesh``.  The
train step writes its params and moments in place and a decode step its
cache: their bytes alias.  No kernel launches.  MoE archs carry
``moe_flops_scale``.  Each cell's ``useful_ratio`` lies in (0.1, 1.05]:
above, work went uncounted; under, it was counted at global shapes
(×256 here).  The recurrences are costed on 2 of their steps (the dry
run's scaling, so it is under these bounds too).  The batch-1
``long_500k`` cells are the exception: one
token's norms, rotary angles and cache bookkeeping are the same on every
rank, and at SMOKE's 64 features they outweigh the rank's 1/256 of the
products (useful 0.018–0.030); for them the rank's FLOPs are held under
a quarter of the same cell's on a world of one.  One FULL cell,
qwen2-0.5b ``decode_32k``, checks ``hbm_fit`` and the layout's
arithmetic at full size.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.distributed.sharding import batch_pspec as j_batch_pspec
from repro.distributed.sharding import cache_pspecs as j_cache_pspecs
from repro.distributed.sharding import fsdp_axes as j_fsdp_axes
from repro.distributed.sharding import param_pspecs as j_param_pspecs
from repro.launch import specs as js
from repro.models import init_decode_cache as j_init_decode_cache
from repro.models import init_model as j_init_model
from repro.train.optim import OptConfig as JOptConfig
from repro.train.optim import adamw_init as j_adamw_init

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import CELLS, SHAPES, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hw
from repro_torch.launch.specs import moe_flops_scale

SMALL = {"train_4k": (16, 16), "prefill_32k": (16, 16),
         "decode_32k": (16, 16), "long_500k": (32, 1)}  # (sequence, batch)
# the recurrences' time loops run 2 steps and count them for all, the
# dry run's costing (held against whole loops in
# test_torch_launch_counter.py)
STEPS_COSTED = 2
J_MESH = AbstractMesh((16, 16), ("data", "model"))
# the MoE and recurrent archs run in test_torch_launch_lm_cells_mixed.py
MIXED = ("xlstm-350m", "mixtral-8x7b", "llama4-scout-17b-a16e",
         "jamba-v0.1-52b")
RUN = [(a, c["shape"].name) for a, cs in CELLS.items() for c in cs
       if not c["skip"] and a not in MIXED]


def _shape(name, small=SMALL):
    S, B = small[name]
    return dataclasses.replace(SHAPES[name], seq_len=S, global_batch=B)


def _local_bytes(sds_tree, spec_tree):
    leaves = jax.tree.leaves(sds_tree)
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda s: isinstance(s, P))
    assert len(leaves) == len(specs)
    return sum(int(np.prod(NamedSharding(J_MESH, s).shard_shape(x.shape)))
               * x.dtype.itemsize for x, s in zip(leaves, specs))


def _jax_bytes(jcfg, shape):
    """(argument bytes, donated bytes) of one rank of the reference's
    cell on the 16 × 16 mesh."""
    if jcfg.num_experts:
        jcfg = dataclasses.replace(jcfg, moe_dispatch="dense")
    params = jax.eval_shape(functools.partial(j_init_model, jcfg),
                            jax.random.key(0))
    pb = _local_bytes(params, j_param_pspecs(params, jcfg, J_MESH))
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        cache = jax.eval_shape(functools.partial(j_init_decode_cache, jcfg,
                                                 B, S))
        cb = _local_bytes(cache, j_cache_pspecs(jcfg, J_MESH, cache))
        dp = j_fsdp_axes(J_MESH)
        n = int(np.prod([J_MESH.shape[a] for a in dp]))
        tok = jax.ShapeDtypeStruct((B,), jnp.int32)
        tb = _local_bytes(tok, P(dp if B % n == 0 else None))
        return pb + 2 * tb + cb, cb
    batch = js._batch_sds(jcfg, B, S)
    if shape.kind == "prefill":
        batch.pop("targets")
    bb = _local_bytes(batch, j_batch_pspec(jcfg, J_MESH, batch))
    if shape.kind == "prefill":
        return pb + bb, 0
    plan = js.train_plan(jcfg, J_MESH)
    opt = jax.eval_shape(functools.partial(
        j_adamw_init, cfg=JOptConfig(moment_dtype=plan["moment_dtype"])),
        params)
    mb = 2 * _local_bytes(opt.mu, j_param_pspecs(params, jcfg, J_MESH))
    return pb + mb + 4 + bb, pb + mb


def run_docs(run, small=SMALL):
    """Every cell of ``run``'s dry-run document on the fake world of 256
    at ``small``'s sizes, and the long_500k cells' on a world of one;
    the recurrences costed on ``STEPS_COSTED`` of their steps."""
    before = ops.launch_counts()
    out, one = {}, {}
    with pytest.MonkeyPatch.context() as mp, dryrun.fake_world(256):
        mp.setattr(dryrun, "STEPS_COSTED", STEPS_COSTED)
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        for arch, name in run:
            out[arch, name] = dryrun.run_cell(
                arch, name, mesh=mesh, cfg=smoke_config(arch),
                lm_shape=_shape(name, small), out_dir=None, verbose=False)
    with pytest.MonkeyPatch.context() as mp, dryrun.fake_world(1):
        mp.setattr(dryrun, "STEPS_COSTED", STEPS_COSTED)
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        for arch, name in run:
            if name == "long_500k":
                one[arch] = dryrun.run_cell(
                    arch, name, mesh=mesh, cfg=smoke_config(arch),
                    lm_shape=_shape(name, small), out_dir=None, verbose=False)
    return out, one, (before, ops.launch_counts())


@pytest.fixture(scope="module")
def docs():
    return run_docs(RUN)


def check_argument_bytes(doc, arch, name, small=SMALL):
    args, donated = _jax_bytes(j_smoke_config(arch), _shape(name, small))
    mem = doc["memory_analysis"]
    assert mem["argument_size_in_bytes"] == args
    assert mem["alias_size_in_bytes"] == donated
    assert mem["total_nonalias_bytes"] >= args - donated
    assert doc["mesh"] == "pod16x16" and doc["chips"] == 256


def _grad_reduction(arch):
    """(whether any of ``arch``'s SMOKE params is split over ``data`` on
    the 16 x 16 mesh, the f32 bytes a rank holds of those whole over
    ``data``)."""
    from repro_torch.distributed.sharding import param_pspecs
    from repro_torch.launch.specs import _params_meta
    from repro_torch.tree import tree_leaves
    cfg = smoke_config(arch)
    params = _params_meta(cfg)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    specs = tree_leaves(param_pspecs(params, cfg, mesh))
    fsdp, whole = False, 0
    for t, spec in zip(tree_leaves(params), specs):
        axes = [a for e in spec if e for a in ((e,) if isinstance(e, str)
                                               else e)]
        if "data" in axes:
            fsdp = True
        else:
            whole += 4 * t.numel() // (16 if "model" in axes else 1)
    return fsdp, whole


def check_useful_ratio_and_flops_scale(docs, arch, name):
    doc = docs[0][arch, name]
    assert doc["meta"]["flops_scale"] == moe_flops_scale(smoke_config(arch))
    assert doc["meta"]["flops_scale"] == js.moe_flops_scale(
        j_smoke_config(arch))
    if smoke_config(arch).num_experts:
        assert doc["meta"]["flops_scale"] < 1.0
    assert doc["useful_ratio"] <= 1.05
    if name == "long_500k":
        assert doc["flops_per_device"] < docs[1][arch]["flops_per_device"] / 4
    else:
        assert doc["useful_ratio"] > 0.1
    assert doc["t_compute"] > 0 and doc["t_memory"] > 0
    assert doc["meta"]["sizing"] == smoke_config(arch).name
    if SHAPES[name].kind == "train":
        # the gradients' reduction over the data ranks: the FSDP-sharded
        # params' by reduce-scatters, every param whole over ``data``
        # all-reduced (f32, its local bytes at least once)
        fsdp, whole = _grad_reduction(arch)
        if fsdp:
            assert doc["coll_breakdown"]["reduce_scatter"] > 0
        assert doc["coll_breakdown"]["all_reduce"] >= whole
    recurrent = set(smoke_config(arch).block_pattern) & {"mamba", "slstm"}
    if recurrent and SHAPES[name].kind != "decode":
        assert 0 < doc["meta"]["steps_costed"] < doc["meta"]["steps_total"]


@pytest.mark.parametrize("arch, name", RUN)
def test_argument_bytes_are_jax_shards(docs, arch, name):
    check_argument_bytes(docs[0][arch, name], arch, name)


@pytest.mark.parametrize("arch, name", RUN)
def test_useful_ratio_and_flops_scale(docs, arch, name):
    check_useful_ratio_and_flops_scale(docs, arch, name)


def test_no_kernel_launches(docs):
    before, after = docs[2]
    assert before == after


def test_full_qwen2_decode_fits_256_ranks():
    with dryrun.fake_world(256):
        doc = dryrun.run_cell("qwen2-0.5b", "decode_32k", out_dir=None,
                              verbose=False)
    mem = doc["memory_analysis"]
    args, cache = _jax_bytes(j_get_config("qwen2-0.5b"), SHAPES["decode_32k"])
    assert mem["argument_size_in_bytes"] == args
    assert mem["alias_size_in_bytes"] == cache
    # FULL: 24 layers of (128, 2, 32768, 64) bf16 k and v, batch over the
    # 16 data ranks, the 2 KV heads too few for 16: the sequence over model
    assert cache == 2 * 24 * (128 // 16) * 2 * (32768 // 16) * 64 * 2
    assert doc["hbm_fit"] == (mem["total_nonalias_bytes"] <= hw.HBM_BYTES)
    assert doc["hbm_fit"]
    assert doc["meta"]["constants"]["HBM_BYTES"] == 80 * 10**9
