"""The composable LM: stacked stages over heterogeneous blocks.

Port of ``repro/models/model.py``.  ``init_model`` stacks each stage
slot's parameters over the R repeats (a leading axis ``R`` under
``params["stages"]["slot{i}"]``, the reference's tree and keys), and
``forward``/``decode_step`` loop over the repeats where the reference
scans.  Params are plain nested dicts of tensors, so
``params_from_jax`` is a tree map and ``train/checkpoint.py`` saves and
restores them (each package reads the other's checkpoints).

Params are stored fp32 (optimizer master copy); compute casts them to
``cfg.dtype`` at each use.  MoE aux losses sum over the repeats.
Frontend-stub archs (llava/hubert) consume precomputed (B, S, D_in)
embeddings through a learned projector instead of token ids.

``decode_step`` writes each repeat's cache slot in place on the stacked
cache (the port's counterpart of donation) and returns it.  The
reference's ``unroll`` and ``act_spec`` (scan unrolling and a sharding
constraint) have no torch counterpart and are not taken.

``remat`` recomputes each repeat's stage in the backward pass, as the
reference's ``jax.checkpoint(stage)``: ``"full"`` saves nothing inside
the stage (``torch.utils.checkpoint``); ``"dots"`` is the reference's
``dots_with_no_batch_dims_saveable``, a selective checkpoint that saves
the outputs of the products with no batch dims (``aten.mm`` and
``aten.addmm``: every ``x @ W`` of an activation by a weight) and
recomputes everything else, the attention's batched products included.

The same functions take DTensor params on a ``DeviceMesh`` (the dry
run's LM cells, ``launch/specs.py``; values as on one device): plain
tensors made on the way read as replicated (``layers.on_mesh``), the
residual stream is pinned to batch over the FSDP axes, whole on the
other axes (``layers.pin_batch``), each slot's weights are gathered over
the FSDP axes at use in training and prefill (``layers.unshard``) and
read where they lie in decode, each product on the weight's shards
(``layers.dot``), and the token embedding and the cross-entropy are
vocab-parallel (``_embed_sharded``, ``_nll``).  On plain tensors none of
this runs.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import ssm, xlstm
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import (dense_init, dot, grad_layout,
                                       init_mlp, mlp, on_mesh, pin_batch,
                                       rms_norm, unshard)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.tree import tree_map

__all__ = ["init_model", "forward", "forward_hidden", "loss_fn",
           "decode_step", "init_decode_cache", "params_from_jax"]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _stack(trees):
    """One tree whose leaves stack the given trees' leaves on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def params_from_jax(tree, device="cuda"):
    """The port's params (or decode cache) from the reference's tree.

    ``tree`` is what the reference's ``init_model`` (or
    ``init_decode_cache``) returns, as nested dicts whose leaves are
    arrays that ``numpy.asarray`` takes (JAX arrays or numpy); each leaf
    becomes a tensor on ``device`` with the same key, shape and dtype.
    """
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(
        device), tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_slot(gen, cfg: ModelConfig, slot: int, dtype):
    kind = cfg.block_pattern[slot]
    dev = gen.device
    p: Dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), device=dev)}
    if kind == "attn":
        p["attn"] = attn.init_attention(gen, cfg, dtype)
    elif kind == "mamba":
        p["mamba"] = ssm.init_mamba(gen, cfg, dtype)
    elif kind == "mlstm":
        p["mlstm"] = xlstm.init_mlstm(gen, cfg, dtype)
    elif kind == "slstm":
        p["slstm"] = xlstm.init_slstm(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    if kind in ("attn", "mamba") and cfg.d_ff:
        p["norm2"] = torch.ones((cfg.d_model,), device=dev)
        if cfg.is_moe_slot(slot):
            p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                                dtype)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_model(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32):
    """Random params drawn from ``gen``, on ``gen``'s device."""
    dev = gen.device
    params: Dict[str, Any] = {}
    params["embed"] = dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                 scale=1.0, dtype=dtype)
    if cfg.frontend != "none":
        # modality stub: precomputed frame/patch embeddings -> projector
        # (token embed above still serves the text side / decode path)
        params["frontend_proj"] = dense_init(
            gen, (cfg.d_model, cfg.d_model), dtype=dtype)
    params["stages"] = {
        f"slot{slot}": _stack([_init_slot(gen, cfg, slot, dtype)
                               for _ in range(cfg.repeats)])
        for slot in range(cfg.stage_period)}
    params["final_norm"] = torch.ones((cfg.d_model,), device=dev)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                    dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# stage application
# ---------------------------------------------------------------------------

def _apply_slot_train(slot_params, cfg: ModelConfig, slot: int, x, positions):
    kind = cfg.block_pattern[slot]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, slot_params["norm1"], cfg.norm_eps)
    # each block's output reduced onto the residual's layout before the
    # add (``pin_batch``): DTensor would otherwise pick where a partial
    # sum is reduced, and torch versions pick differently.  In the
    # backward pass the residual's gradient is a partial sum over
    # ``model`` (the blocks' tensor-parallel products make it one) but
    # where a head that splits K hands it back whole: it is taken as a
    # partial sum at each add (``grad_layout``), so that it meets the
    # block's gradient in one layout
    if kind == "attn":
        out = attn.attention_train(slot_params["attn"], cfg, h, positions,
                                   slot)
    elif kind == "mamba":
        out = ssm.mamba_train(slot_params["mamba"], cfg, h)
    elif kind == "mlstm":
        out = xlstm.mlstm_train(slot_params["mlstm"], cfg, h)
    elif kind == "slstm":
        out, _ = xlstm.slstm_apply(slot_params["slstm"], cfg, h)
    x = pin_batch(grad_layout(x, "partial") + pin_batch(out))
    if kind in ("attn", "mamba") and cfg.d_ff:
        h2 = rms_norm(x, slot_params["norm2"], cfg.norm_eps)
        if cfg.is_moe_slot(slot):
            out, aux = moe_ffn(slot_params["moe"], h2, cfg.top_k,
                               dispatch=cfg.moe_dispatch)
        else:
            out = mlp(slot_params["mlp"], h2)
        x = grad_layout(x, "partial") + pin_batch(out)
    return pin_batch(x), aux


def _apply_slot_decode(slot_params, cfg: ModelConfig, slot: int, x, pos,
                       cache_slot):
    kind = cfg.block_pattern[slot]
    h = rms_norm(x, slot_params["norm1"], cfg.norm_eps)
    new_cache = cache_slot
    if kind == "attn":
        out, new_cache = attn.attention_decode(slot_params["attn"], cfg, h,
                                               pos, cache_slot, slot)
    elif kind == "mamba":
        out, new_cache = ssm.mamba_decode(slot_params["mamba"], cfg, h,
                                          cache_slot)
    elif kind == "mlstm":
        out, new_cache = xlstm.mlstm_decode(slot_params["mlstm"], cfg, h,
                                            cache_slot)
    elif kind == "slstm":
        out, new_cache = xlstm.slstm_apply(slot_params["slstm"], cfg, h,
                                           cache_slot)
    x = pin_batch(x + pin_batch(out))
    if kind in ("attn", "mamba") and cfg.d_ff:
        h2 = rms_norm(x, slot_params["norm2"], cfg.norm_eps)
        if cfg.is_moe_slot(slot):
            out, _ = moe_ffn(slot_params["moe"], h2, cfg.top_k,
                             dispatch=cfg.moe_dispatch)
        else:
            out = mlp(slot_params["mlp"], h2)
        x = x + pin_batch(out)
    return pin_batch(x), new_cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, batch):
    dt = torch_dtype(cfg.dtype)
    if cfg.frontend != "none" and "embeddings" in batch:
        return dot(batch["embeddings"].to(dt),
                   unshard(params["frontend_proj"]).to(dt))
    if type(params["embed"]).__name__ == "DTensor":
        return _embed_sharded(params["embed"], batch["inputs"]).to(dt)
    # gather, then cast: the reference's cast-then-gather, value for value
    return params["embed"][batch["inputs"]].to(dt)


def _embed_sharded(table, ids):
    """The token embedding on a DTensor table (V, D): every rank looks up
    all the ids in its block of the table; a block of the vocab holds
    zeros for the ids outside it, so the rows are partial sums over the
    vocab's mesh dims and split over the features' (the vocab-parallel
    lookup, the table never gathered)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.models.layers import shard_offset
    mesh = table.device_mesh
    ids_l = ids.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    t_l = table.to_local()
    v = ids_l.to(torch.int64) - shard_offset(table, 0)
    inside = (v >= 0) & (v < t_l.shape[0])
    rows = t_l[v.clamp(0, t_l.shape[0] - 1)] * inside[..., None]
    out = [Partial() if isinstance(p, Shard) and p.dim == 0 else
           Shard(ids.dim()) if isinstance(p, Shard) else Replicate()
           for p in table.placements]
    return DTensor.from_local(rows, mesh, out, run_check=False)


def _nll(logits, targets):
    """-log softmax(logits) at each target (targets clamped at 0)."""
    tsafe = torch.clamp(targets, min=0).to(torch.int64)
    if type(logits).__name__ != "DTensor":
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, tsafe[..., None])[..., 0]
    if not any(p.is_shard(logits.dim() - 1) for p in logits.placements):
        return _nll_whole_vocab(logits, tsafe)
    # vocab-parallel, on each rank's shard: the max and the sum of the
    # exponentials reduce over the vocab's mesh dims, and each rank
    # picks the targets that fall in its block of the vocab
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.models.layers import batch_placements, shard_offset
    mesh = logits.device_mesh
    last = logits.dim() - 1
    bpl = batch_placements(targets, mesh)
    vocab = [isinstance(p, Shard) and p.dim == last for p in logits.placements]
    zpl = [Shard(last) if v else b for b, v in zip(bpl, vocab)]
    z = logits.redistribute(mesh, zpl)
    z_l = z.to_local()

    def reduce(t, op):
        part = [Partial(op) if v else b for b, v in zip(bpl, vocab)]
        whole = [Replicate() if v else b for b, v in zip(bpl, vocab)]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, whole).to_local()

    m = reduce(z_l.detach().amax(-1), "max")
    lse = m + torch.log(reduce(torch.exp(z_l - m[..., None]).sum(-1), "sum"))
    v = tsafe.redistribute(mesh, bpl).to_local() - shard_offset(z, last)
    inside = (v >= 0) & (v < z_l.shape[-1])
    picked = torch.gather(z_l, -1, v.clamp(0, z_l.shape[-1] - 1)[..., None])
    picked = reduce(picked[..., 0] * inside, "sum")
    return DTensor.from_local(lse - picked, mesh, bpl, run_check=False)


def _nll_whole_vocab(logits, tsafe):
    """``_nll`` of a DTensor whose vocab no rank splits: the plain
    log-softmax on each rank's rows."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.layers import batch_placements, local_parts
    mesh = logits.device_mesh
    pl = batch_placements(tsafe, mesh)
    z_l, = local_parts(mesh, [(logits, pl)])
    t_l = tsafe.redistribute(mesh, pl).to_local()
    logp = torch.log_softmax(z_l, dim=-1)
    nll = -torch.gather(logp, -1, t_l[..., None])[..., 0]
    return DTensor.from_local(nll, mesh, pl, run_check=False)


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the 2-D products."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(stage, remat: str):
    """``stage`` under the reference's ``remat`` policy."""
    if remat == "none":
        return stage
    if remat == "full":
        return functools.partial(ckpt.checkpoint, stage, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, stage, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {remat!r}")


@on_mesh
def forward_hidden(params, cfg: ModelConfig, batch, *, remat: str = "none"):
    """Backbone only: final hidden states (B, S, D) + MoE aux loss."""
    x = pin_batch(_embed(params, cfg, batch))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)

    def stage(x, stage_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for slot in range(cfg.stage_period):
            x, a = _apply_slot_train(
                tree_map(unshard, stage_params[f"slot{slot}"]), cfg, slot,
                x, positions)
            aux = aux + a
        return x, aux

    stage = _remat(stage, remat)
    # one view per repeat of each stacked leaf: the backward stacks their
    # gradients once (indexing t[r] per repeat would zero-fill and add a
    # whole stacked leaf per repeat)
    repeats = tree_map(lambda t: t.unbind(0), params["stages"])
    auxs = []
    for r in range(cfg.repeats):
        x, aux = stage(x, tree_map(lambda ts: ts[r], repeats))
        auxs.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(auxs).sum()


def forward(params, cfg: ModelConfig, batch, *, remat: str = "none"):
    """Full-sequence forward. Returns (logits (B, S, V), aux_loss)."""
    x, aux = forward_hidden(params, cfg, batch, remat=remat)
    logits = dot(x.to(torch.float32),
                 unshard(_head(params, cfg)).to(torch.float32))
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch, *, remat: str = "none"):
    """Mean CE over valid targets (+ MoE aux). Returns (loss, metrics)."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    targets = batch["targets"]
    valid = (targets >= 0).to(torch.float32)
    nll = _nll(logits, targets)
    denom = torch.clamp(valid.sum(), min=1.0)
    ce = (nll * valid).sum() / denom
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "tokens": valid.sum()}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _init_cache_slot(cfg: ModelConfig, slot: int, batch: int, max_len: int,
                     dtype, device):
    kind = cfg.block_pattern[slot]
    if kind == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, slot, dtype, device)
    if kind == "mamba":
        return ssm.init_mamba_cache(cfg, batch, device=device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm.init_slstm_cache(cfg, batch, device)
    raise ValueError(kind)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda"):
    """Per-slot caches stacked over the R repeats."""
    return {f"slot{slot}": tree_map(
        lambda t: t[None].repeat((cfg.repeats,) + (1,) * t.dim()),
        _init_cache_slot(cfg, slot, batch, max_len, dtype, device))
        for slot in range(cfg.stage_period)}


@on_mesh
def decode_step(params, cfg: ModelConfig, tokens, pos, cache):
    """One decode step. tokens (B,) int, pos (B,) int absolute.

    Returns (logits (B, V) float32, cache): every repeat's slot of the
    stacked ``cache`` is written in place.
    """
    dt = torch_dtype(cfg.dtype)
    # token decode path (VLM/audio frontends only matter at prefill)
    x = pin_batch(_embed(params, cfg, {"inputs": tokens[:, None]}))  # (B,1,D)
    for r in range(cfg.repeats):
        for slot in range(cfg.stage_period):
            name = f"slot{slot}"
            slot_params = tree_map(lambda t: t[r], params["stages"][name])
            views = {k: t[r] for k, t in cache[name].items()}
            x, new = _apply_slot_decode(slot_params, cfg, slot, x, pos,
                                        views)
            for k, t in new.items():
                if t is not views[k]:
                    if type(t).__name__ == "DTensor":
                        t = t.redistribute(t.device_mesh, views[k].placements)
                    views[k].copy_(t)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dot(x[:, 0].to(torch.float32),
                 _head(params, cfg).to(torch.float32))
    return logits, cache
