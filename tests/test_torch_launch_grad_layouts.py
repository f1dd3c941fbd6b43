"""The gradient layouts the model states (``layers.grad_layout``), counted
on a fake 4 × 4 world.

Where a gradient that is whole over ``model`` meets one that is a partial
sum there, DTensor picks the layout of their sum, and torch versions pick
apart: 2.11 reduces the partial one, 2.13 divides the whole one into a
partial sum (``Partial._partition_value``).  The model takes such
gradients as partial sums itself (the residual stream at each add, the
mLSTM's gates' input and its z, the router's input), and reduces the MoE
gates' gradient itself, once, so that no such choice is left to DTensor.
Each arch's train cell runs at SMOKE on small shapes, one width changed
so that its FULL layout on 16 × 16 appears on 4 × 4: mixtral-8x7b with 6
experts (not split over ``model``, as its 8 are not over 16), hubert-xlarge
with a vocab of 30 (which ``model`` does not divide, so the head splits
K, as 504 over 16 does), xlstm-350m with one head (its 2 gate columns
whole over ``model``, as its 8 are over 16).  A counter keeps each
division and collective of the rank with the frames it came from
(``_site``): no division of DTensor's own may
partition a gradient, the model's own are where it states them, and the
gates' gradient is reduced by one all-reduce a MoE layer.
"""

import collections
import dataclasses
import traceback
from pathlib import Path

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as tr

WIDTHS = {"mixtral-8x7b": {"num_experts": 6},
          "hubert-xlarge": {"vocab_size": 30},
          "xlstm-350m": {"num_heads": 1}}
B, S = 16, 16          # the global batch and sequence of the cells


_SEEN: dict = {}        # arch -> (_ops' result), each cell counted once


def _site():
    """Where an op is issued: the innermost frames of the port and of
    DTensor on the stack (``file:line function``), outermost first."""
    frames = [f for f in traceback.extract_stack()
              if ("/repro_torch/" in f.filename
                  and not f.filename.endswith("roofline.py"))
              or "/torch/distributed/tensor/" in f.filename
              or "/torch/autograd/" in f.filename]
    return " < ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}"
                      for f in reversed(frames[-8:]))


def _ops(monkeypatch, arch):
    """(op, argument shapes, site) of each division and collective of
    the arch's train cell on rank 0 of a fake 4 × 4 world; and its
    config."""
    if arch not in _SEEN:
        _SEEN[arch] = _count(monkeypatch, arch)
    return _SEEN[arch]


def _count(monkeypatch, arch):
    seen = []

    class Tally(tr.CostCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = str(func)
            if out is not NotImplemented and not tr._PROPAGATING[0] and (
                    name.startswith(("_c10d_functional.all",
                                     "_c10d_functional.reduce",
                                     "_dtensor.shard"))
                    or name.startswith("aten.div")):
                seen.append((name, tuple(tuple(t.shape) for t in
                                         tree_flatten(args)[0]
                                         if isinstance(t, torch.Tensor)),
                             _site()))
            return out

    monkeypatch.setattr(dryrun, "CostCounter", Tally)
    cfg = dataclasses.replace(smoke_config(arch), **WIDTHS[arch])
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S,
                                global_batch=B)
    with dryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        dryrun.run_cell(arch, "train_4k", mesh=mesh, cfg=cfg,
                        lm_shape=shape, out_dir=None, verbose=False)
    return seen, cfg


def _innermost(site):
    return site.split(" < ")[0]


@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_no_gradient_is_partitioned_by_dtensor(monkeypatch, arch):
    """No division of DTensor's own splits a whole gradient into a partial
    sum; the model's own divisions (``_GradLayout.backward``) are where
    it states them: once a train step at the last block's residual add
    (hubert's head hands the stream's gradient back whole), twice an
    mLSTM block (the gates' input, z), once a MoE layer (the router's
    input)."""
    seen, cfg = _ops(monkeypatch, arch)
    divs = [(s, site) for f, s, site in seen if f.startswith("aten.div")
            and len(s[0]) >= 2]
    assert not [d for d in divs if "_partition_value" in d[1]]
    ours = collections.Counter(s for s, site in divs
                               if _innermost(site).startswith("layers.py")
                               and "backward" in _innermost(site))
    mlstm = sum(k == "mlstm" for k in cfg.block_pattern) * cfg.repeats
    want = {"hubert-xlarge": 1, "xlstm-350m": 2 * mlstm,
            "mixtral-8x7b": cfg.num_layers}[arch]
    assert sum(ours.values()) == want, ours


def test_moe_gates_gradient_is_reduced_once(monkeypatch):
    """mixtral-8x7b: the top-k gates' gradient, a partial sum over
    ``model`` (the experts' hidden features are split there), is reduced
    by one all-reduce of the rank's (tokens, k) a MoE layer, issued by
    the model; no other collective moves a (tokens, k) or (tokens, 1)
    tensor (torch 2.11 reduced the gates' and their sum's gradients
    apart, 2.13 reduce-scattered both and gathered the result)."""
    seen, cfg = _ops(monkeypatch, "mixtral-8x7b")
    ours = [s[0] for f, s, site in seen
            if f == "_c10d_functional.all_reduce.default"
            and _innermost(site).startswith("layers.py")]
    assert len(ours) == cfg.num_layers
    tokens = ours[0][0]                 # the rank's tokens a microbatch
    assert all(s == (tokens, cfg.top_k) for s in ours), ours
    others = [(f, s) for f, s, site in seen
              if not f.startswith("aten.div")
              and s[0] in ((tokens, cfg.top_k), (tokens, 1))
              and not _innermost(site).startswith("layers.py")]
    assert not others, others


def test_mlstm_input_gradient_is_not_reduced_apart(monkeypatch):
    """xlstm-350m: no all-reduce moves the mLSTM's (batch, S, Di) input
    gradient: its four products' gradients (q, k, v and the gates') meet
    as partial sums and are reduced once, with z's, as the up
    projection's (torch 2.11 all-reduced three of the four apart)."""
    seen, cfg = _ops(monkeypatch, "xlstm-350m")
    di = int(cfg.xlstm_pf * cfg.d_model)
    assert not [s for f, s, _ in seen
                if f == "_c10d_functional.all_reduce.default"
                and s[0] == (B // 4, S, di)]
