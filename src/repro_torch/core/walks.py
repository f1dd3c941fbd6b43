"""Random-walk applications on top of the Bingo sampler (paper §2.2/§6).

Port of the whole-walk half of ``repro/core/walks.py``:

  * ``deepwalk`` — first-order biased walk, fixed length (default 80);
  * ``ppr``      — geometric termination with probability ``stop_prob``;
  * ``simple``   — unbiased neighbor pick.

Each walk batch is one call of the backend's ``sample_walk`` — one
whole-walk kernel launch on the card.  Walkers that terminate (or sit on
degree-0 vertices) emit -1 and hold.  Walks take the raw int32 ``seed``
of the counter-hash PRNG (the reference derives it from a JAX key with
``ops.seed_from_key``).  node2vec and the per-step path
(``whole_walk=False``) come with the per-step sampler in a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from repro_torch.core.backend import get_backend
from repro_torch.core.dyngraph import BingoConfig, BingoState

__all__ = ["WalkParams", "random_walk", "deepwalk", "ppr", "make_walker"]


class WalkParams(NamedTuple):
    kind: str = "deepwalk"     # deepwalk | node2vec | ppr | simple
    length: int = 80
    p: float = 0.5             # node2vec return parameter
    q: float = 2.0             # node2vec in-out parameter
    stop_prob: float = 0.0     # ppr termination probability per step


def random_walk(state: BingoState, cfg: BingoConfig, starts, seed: int,
                params: WalkParams, backend: Optional[str] = None,
                whole_walk: Optional[bool] = None, uniforms=None):
    """Run a batch of walks; returns ``(B, length + 1)`` int32 paths.

    Column 0 holds the start vertices; terminated walkers pad with -1.
    ``seed`` (an int32 value) keys the per-(walker, step) hash stream;
    ``uniforms`` (L, B, 6) float32 pins the stream instead.
    """
    if params.kind == "node2vec":
        raise NotImplementedError(
            "node2vec comes with the per-step sampler in a later slice of "
            "the port")
    if whole_walk is False:
        raise NotImplementedError(
            "the per-step walk path comes with the per-step sampler in a "
            "later slice of the port")
    bk = get_backend(cfg.backend if backend is None else backend)
    return bk.sample_walk(state, cfg, starts, seed, params, u=uniforms)


def deepwalk(state, cfg, starts, seed: int, length: int = 80,
             backend: Optional[str] = None):
    return random_walk(state, cfg, starts, seed,
                       WalkParams(kind="deepwalk", length=length),
                       backend=backend)


def ppr(state, cfg, starts, seed: int, max_length: int = 400,
        stop_prob: float = 1.0 / 80.0, backend: Optional[str] = None):
    return random_walk(state, cfg, starts, seed,
                       WalkParams(kind="ppr", length=max_length,
                                  stop_prob=stop_prob), backend=backend)


def make_walker(state: BingoState, cfg: BingoConfig, params: WalkParams,
                backend: Optional[str] = None,
                whole_walk: Optional[bool] = None):
    """Walk closure ``run(st, starts, seed) -> (st, path)`` — the
    reference's signature; the state passes through untouched."""
    def run(st, starts, seed):
        return st, random_walk(st, cfg, starts, seed, params,
                               backend=backend, whole_walk=whole_walk)
    return run
