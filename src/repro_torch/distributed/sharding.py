"""Logical sharding rules for every architecture on the production mesh.

Port of ``repro/distributed/sharding.py``: the same rules over the
port's params, batch and decode-cache trees (nested dicts of tensors
with the reference's keys; tensors on the ``meta`` device do).  Mesh
axes: ``data`` (16) × ``model`` (16), plus ``pod`` (2) multi-pod.

  * FSDP — every weight matrix shards its input-features dim over
    ``data`` (× ``pod``).
  * TP   — output features (heads / d_ff / vocab) shard over ``model``.
  * EP   — the expert dim shards over ``model`` when ``E % 16 == 0``
    (llama4, jamba); otherwise experts keep d_ff-TP (mixtral's 8).
  * Every rule is divisibility-checked with a replicate fallback, so odd
    dims (yi-34b's 56 heads, hubert's 504 vocab) replicate.

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``
reads: ``None``, an axis name, or a tuple of names (a one-name tuple
reads as the name).  A mesh is anything with ``axis_names`` and a
``shape`` mapping names to sizes (the reference's meshes), or a
``DeviceMesh`` (``mesh_dim_names``).  ``placements(spec, mesh)`` turns a
spec into the ``Shard``/``Replicate`` list, one per mesh dim, that
``torch.distributed.tensor.distribute_tensor`` takes.
"""

from __future__ import annotations

from typing import Any

__all__ = ["fsdp_axes", "param_pspecs", "batch_pspec", "cache_pspecs",
           "axis_size", "placements"]


def _axes(mesh) -> dict:
    """{axis name: size} of a reference-style mesh or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is not None:
        return {a: mesh.shape[a] for a in names}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in _axes(mesh) else ("data",)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _maybe(mesh, axes, dim: int):
    """axes if ``dim`` divides their product, else None (replicate)."""
    if axes is None:
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


def _spec(*entries) -> tuple:
    """A spec as a ``PartitionSpec`` reads: a one-name tuple is the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _matrix_spec(mesh, shape, *, lead_none: int, in_axes, out_axes):
    """(in_axes on dim -2, out_axes on dim -1) with divisibility checks."""
    return _spec(*([None] * lead_none), _maybe(mesh, in_axes, shape[-2]),
                 _maybe(mesh, out_axes, shape[-1]))


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params, cfg, mesh) -> Any:
    """Spec tree matching ``init_model(cfg, ...)``'s structure."""
    fsdp = fsdp_axes(mesh)
    ep_ok = cfg.num_experts and cfg.num_experts % axis_size(mesh, "model") == 0

    def rule(names, leaf):
        name = names[-1]
        stacked = "stages" in names           # leading R axis
        lead = 1 if stacked else 0
        nd = leaf.dim()
        # --- embeddings / head ---------------------------------------------
        if name == "embed":
            return _spec(_maybe(mesh, "model", leaf.shape[0]),
                         _maybe(mesh, fsdp, leaf.shape[1]))
        if name == "head":
            return _spec(_maybe(mesh, fsdp, leaf.shape[0]),
                         _maybe(mesh, "model", leaf.shape[1]))
        if name == "frontend_proj":
            return _spec(_maybe(mesh, fsdp, leaf.shape[0]), None)
        # --- MoE -------------------------------------------------------------
        if "moe" in names:
            if name == "router":
                return _spec(*([None] * lead),
                             _maybe(mesh, fsdp, leaf.shape[lead]), None)
            if nd == lead + 3:                # (R, E, D, F) expert weights
                if ep_ok:
                    return _spec(*([None] * lead), "model",
                                 _maybe(mesh, fsdp, leaf.shape[lead + 1]),
                                 None)
                return _matrix_spec(
                    mesh, leaf.shape, lead_none=lead + 1,
                    in_axes=fsdp if name != "wo" else "model",
                    out_axes="model" if name != "wo" else fsdp)
        # --- generic 2-D weights ------------------------------------------
        if nd == lead + 2:
            out_proj = name in ("wo", "w_down", "out_proj", "dt_proj")
            return _matrix_spec(
                mesh, leaf.shape, lead_none=lead,
                in_axes="model" if out_proj else fsdp,
                out_axes=fsdp if out_proj else "model")
        if nd == lead + 3 and name == "r_h":  # sLSTM block-diag recurrence
            return _spec(*([None] * lead), None, None, None)
        # --- vectors (norms, biases, gates) --------------------------------
        return _spec(*([None] * nd))

    return _map_path(rule, params)


def batch_pspec(cfg, mesh, batch_example) -> Any:
    """Input-batch specs: batch dim over (pod, data) when divisible."""
    dp = fsdp_axes(mesh)

    def rule(_names, leaf):
        b = leaf.shape[0]
        ax = _maybe(mesh, dp, b)
        if ax is None and b % _axes(mesh)[dp[-1]] == 0:
            ax = dp[-1]                       # data only (e.g. batch 16)
        return _spec(ax, *([None] * (leaf.dim() - 1)))

    return _map_path(rule, batch_example)


def cache_pspecs(cfg, mesh, cache_example) -> Any:
    """Decode-cache specs.

    KV leaves are (R, B, Hkv, T, dh): batch over (pod, data) when it
    divides; KV heads over ``model`` when they divide, else the cache
    *sequence* shards over ``model`` (long-context batch-1 cells).
    Recurrent states (mamba/xlstm) shard batch and the channel dim.
    """
    dp = fsdp_axes(mesh)

    def rule(names, leaf):
        name = names[-1]
        if name in ("k", "v") and leaf.dim() == 5:
            R, B, Hkv, T, dh = leaf.shape
            b_ax = _maybe(mesh, dp, B) or _maybe(mesh, "data", B)
            h_ax = _maybe(mesh, "model", Hkv)
            t_ax = None if h_ax else _maybe(mesh, "model", T)
            if b_ax is None and t_ax is None and h_ax is None:
                # batch-1 long-decode: spread sequence over everything
                t_ax = _maybe(mesh, ("data", "model"), T)
            return _spec(None, b_ax, h_ax, t_ax, None)
        # recurrent state: (R, B, ...) — batch + widest trailing dim
        B = leaf.shape[1]
        b_ax = _maybe(mesh, dp, B) or _maybe(mesh, "data", B)
        spec = [None, b_ax] + [None] * (leaf.dim() - 2)
        if leaf.dim() >= 3:
            spec[2] = _maybe(mesh, "model", leaf.shape[2])
        return _spec(*spec)

    return _map_path(rule, cache_example)


def placements(spec, mesh) -> list:
    """The ``distribute_tensor`` placements of ``spec`` on ``mesh``: for
    each mesh dim, ``Shard(d)`` where tensor dim ``d``'s entry names it,
    else ``Replicate()``.  A dim over several axes is split over them in
    the mesh's order (the spec's order must agree)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(_axes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out
