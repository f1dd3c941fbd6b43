"""Pluggable engine backends — one interface, looked up by name.

Port of ``repro/core/backend.py``.  Every layer that samples from the
Bingo sampling space (a walk step, node2vec proposals, whole walks) or
mutates it with batched §5.2 rounds goes through an ``EngineBackend``
named by ``cfg.backend``:

  * ``"fused"`` — the counterpart of the reference's ``PallasBackend``:
    per-step samples through the per-step kernels (``csrc/walk_sample.cu``,
    rows read in place), whole walks through the whole-walk kernel and
    update rounds through the update kernel, all via ``kernels/ops.py``
    (their plain versions on CPU tensors).  ``"auto"`` resolves to it: on
    the card that is the kernels.
  * ``"reference"`` — the plain torch engine of ``core/sampler.py``
    (registered lazily on first lookup), which runs no kernel.
"""

from __future__ import annotations

from typing import Dict, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core.dyngraph import BingoConfig, BingoState

__all__ = ["EngineBackend", "register_backend", "get_backend",
           "available_backends", "FusedBackend"]


@runtime_checkable
class EngineBackend(Protocol):
    """One Bingo engine: per-walker sampling plus batched graph updates.

    ``sample_step(state, cfg, u (B,) vertices, gen) -> (next_vertex (B,),
    slot (B,))`` — biased hierarchical sample, uniforms drawn from the
    ``torch.Generator`` ``gen`` (on the state's device).
    ``sample_uniform`` — unbiased neighbor pick with the same signature.
    Callers must mask walkers sitting on degree-0 vertices.

    ``apply_updates(state, cfg, is_insert, u, v, w, active=None) ->
    (state, UpdateStats)`` — one batched §5.2 round with the semantics of
    ``core/updates.batched_update``, applied to ``state`` in place.

    Backends may add the whole-walk capability ``sample_walk(state, cfg,
    starts (B,) int32, seed int, params: WalkParams, u=None) -> (B,
    length+1) int32 path`` — column 0 holds ``starts``, terminated walkers
    pad -1; ``u`` (L, B, 6) optionally pins the uniform stream.

    ``sample_walk_segment(state, cfg, starts, t0, seed, params, u=None,
    wid=None) -> (path (B, length+1), frontier (B, 2))`` is one round of
    the walker relay (``distributed/relay.py``): walker b enters at step
    ``t0[b]``, draws the stream of walker id ``wid[b]``, and exits with a
    ``(vertex, step)`` frontier record on a remote neighbour, encoded
    ``-(g + 2)`` in the state's ``nbr``.  node2vec has no segment path.
    """

    name: str

    def sample_step(self, state: BingoState, cfg: BingoConfig, u, gen
                    ) -> Tuple[torch.Tensor, torch.Tensor]: ...

    def sample_uniform(self, state: BingoState, cfg: BingoConfig, u, gen
                       ) -> Tuple[torch.Tensor, torch.Tensor]: ...

    def apply_updates(self, state: BingoState, cfg: BingoConfig,
                      is_insert, u, v, w, active=None): ...

    def sample_walk_segment(self, state: BingoState, cfg: BingoConfig,
                            starts, t0, seed: int, params, u=None, wid=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]: ...


_REGISTRY: Dict[str, EngineBackend] = {}


def register_backend(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def available_backends() -> Tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY)) + ("auto",)


def get_backend(name: str) -> EngineBackend:
    """Resolve a backend by name; ``"auto"`` is ``"fused"``."""
    _ensure_builtin()
    if name == "auto":
        name = "fused"
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown engine backend {name!r}; "
                         f"available: {available_backends()}") from None


def _ensure_builtin():
    # The reference backend lives in core/sampler.py, which imports this
    # module for the decorator; import it lazily to avoid the cycle.
    if "reference" not in _REGISTRY:
        import repro_torch.core.sampler  # noqa: F401  (registers "reference")


@register_backend
class FusedBackend:
    """Per-step samples, whole walks and update rounds through the kernels.

    ``sample_step``/``sample_uniform`` launch the per-step kernels with the
    walkers' vertices as ``rows`` of the full state tables (read in place;
    the reference gathers (B, C) rows first).  ``sample_walk`` hands the
    state tables to the whole-walk kernel (``csrc/walk_fused.cu``) for
    deepwalk/ppr/simple; node2vec goes to the per-step ``scan_walk``, as
    its Eq. 1 rejection reads the previous hop's row.
    ``sample_walk_segment`` launches the same kernel's segment entry, one
    launch per relay round.  ``apply_updates`` runs one round through the
    update kernel (``csrc/update_fused.cu``).
    """

    name = "fused"

    def sample_step(self, state, cfg, u, gen):
        from repro_torch.kernels import ops
        rows = u.to(torch.int32).contiguous()
        extended = cfg.fp_bias or cfg.base_log2 > 1
        uu = torch.rand((rows.shape[0], 5 if extended else 3), generator=gen,
                        device=gen.device)
        return ops.walk_sample(
            state.itable.prob, state.itable.alias, state.bias, state.nbr,
            state.deg, uu, state.frac if cfg.fp_bias else None,
            base_log2=cfg.base_log2, rows=rows)

    def sample_uniform(self, state, cfg, u, gen):
        from repro_torch.kernels import ops
        rows = u.to(torch.int32).contiguous()
        uu = torch.rand((rows.shape[0], 1), generator=gen, device=gen.device)
        return ops.walk_sample_uniform(state.nbr, state.deg, uu, rows=rows)

    def sample_walk(self, state, cfg, starts, seed, params, u=None):
        from repro_torch.core import walks
        if params.kind == "node2vec":
            return walks.scan_walk(self, state, cfg, starts,
                                   walks.generator(seed, state.nbr.device),
                                   params)
        from repro_torch.kernels import ops
        stop = float(params.stop_prob) if params.kind == "ppr" else 0.0
        return ops.walk_fused(
            state.itable.prob, state.itable.alias, state.bias, state.nbr,
            state.deg, state.frac if cfg.fp_bias else None, starts, seed, u,
            length=params.length, base_log2=cfg.base_log2, stop_prob=stop,
            uniform=params.kind == "simple")

    def sample_walk_segment(self, state, cfg, starts, t0, seed, params,
                            u=None, wid=None):
        from repro_torch.kernels import ops
        args, kw = segment_args(state, cfg, starts, t0, seed, params, u, wid)
        return ops.walk_segment(*args, **kw)

    def apply_updates(self, state, cfg, is_insert, u, v, w, active=None):
        from repro_torch.kernels import ops
        return ops.update_fused(state, cfg, is_insert, u, v, w, active)


def segment_args(state, cfg, starts, t0, seed, params, u, wid):
    """``(args, kwargs)`` of ``walk_segment`` and of its plain version for
    a segment walk of ``params`` on ``state``; node2vec raises
    ``ValueError``, as in the reference."""
    if params.kind == "node2vec":
        raise ValueError("node2vec has no segment path (per-step only)")
    stop = float(params.stop_prob) if params.kind == "ppr" else 0.0
    return ((state.itable.prob, state.itable.alias, state.bias, state.nbr,
             state.deg, state.frac if cfg.fp_bias else None, starts, t0),
            dict(seed=seed, u=u, wid=wid, length=params.length,
                 base_log2=cfg.base_log2, stop_prob=stop,
                 uniform=params.kind == "simple"))
