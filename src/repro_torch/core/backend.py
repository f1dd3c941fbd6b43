"""Pluggable engine backends — one interface, looked up by name.

Port of ``repro/core/backend.py``.  Every layer that samples whole walks
from the Bingo sampling space or mutates it with batched §5.2 rounds goes
through an ``EngineBackend`` named by ``cfg.backend``.  This slice
registers one backend, ``"fused"`` — the counterpart of the reference's
``PallasBackend`` — whose two methods go through ``kernels/ops.py``: the
whole-walk kernel and the batched-update kernel on CUDA tensors, their
plain versions on CPU tensors.  ``"auto"`` resolves to it.
"""

from __future__ import annotations

from typing import Dict, Protocol, Tuple, runtime_checkable

from repro_torch.core.dyngraph import BingoConfig, BingoState

__all__ = ["EngineBackend", "register_backend", "get_backend",
           "available_backends", "FusedBackend"]

WHOLE_WALK_KINDS = ("deepwalk", "ppr", "simple")


@runtime_checkable
class EngineBackend(Protocol):
    """One Bingo engine: whole-walk sampling plus batched graph updates.

    ``sample_walk(state, cfg, starts (B,) int32, seed int, params:
    WalkParams, u=None) -> (B, length+1) int32 path`` — column 0 holds
    ``starts``, terminated walkers pad -1; ``u`` (L, B, 6) optionally pins
    the uniform stream, else the counter hash of ``seed`` is drawn.

    ``apply_updates(state, cfg, is_insert, u, v, w, active=None) ->
    (state, UpdateStats)`` — one batched §5.2 round with the semantics of
    ``core/updates.batched_update``, applied to ``state`` in place.
    """

    name: str

    def sample_walk(self, state: BingoState, cfg: BingoConfig, starts, seed,
                    params, u=None): ...

    def apply_updates(self, state: BingoState, cfg: BingoConfig,
                      is_insert, u, v, w, active=None): ...


_REGISTRY: Dict[str, EngineBackend] = {}


def register_backend(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY)) + ("auto",)


def get_backend(name: str) -> EngineBackend:
    """Resolve a backend by name; ``"auto"`` is ``"fused"``."""
    if name == "auto":
        name = "fused"
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown engine backend {name!r}; "
                         f"available: {available_backends()}") from None


@register_backend
class FusedBackend:
    """Whole walks and update rounds, one kernel launch each on the card.

    ``sample_walk`` hands the full state tables to the whole-walk kernel
    (``csrc/walk_fused.cu``) for deepwalk/ppr/simple; ``apply_updates``
    runs one round through the update kernel (``csrc/update_fused.cu``).
    """

    name = "fused"

    def sample_walk(self, state, cfg, starts, seed, params, u=None):
        if params.kind not in WHOLE_WALK_KINDS:
            raise NotImplementedError(
                f"walk kind {params.kind!r} has no whole-walk path; node2vec "
                "comes with the per-step sampler in a later slice of the port")
        from repro_torch.kernels import ops
        stop = float(params.stop_prob) if params.kind == "ppr" else 0.0
        return ops.walk_fused(
            state.itable.prob, state.itable.alias, state.bias, state.nbr,
            state.deg, state.frac if cfg.fp_bias else None, starts, seed, u,
            length=params.length, base_log2=cfg.base_log2, stop_prob=stop,
            uniform=params.kind == "simple")

    def apply_updates(self, state, cfg, is_insert, u, v, w, active=None):
        from repro_torch.kernels import ops
        return ops.update_fused(state, cfg, is_insert, u, v, w, active)
