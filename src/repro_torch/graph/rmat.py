"""R-MAT graph generator + bias assignment (paper §6.1 datasets).

Copy of ``repro/graph/rmat.py`` (numpy only): the port imports nothing
of the reference package, so it keeps its own copy of the generator.

The paper evaluates on five real-world power-law graphs (Amazon … Twitter)
and cites R-MAT [5] as the reason degree-derived biases follow a power law.
This container has no internet, so the benchmark datasets are R-MAT graphs
with matched skew; the *dry-run* exercises production scale separately.

Host-side data preparation, so plain numpy: this is the data pipeline's CPU
stage (the same role the paper's CPU-side batching plays in Fig. 10(a)).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rmat_edges", "degree_bias", "sample_bias"]


def rmat_edges(scale: int, edge_factor: int = 8, *,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               seed: int = 0, dedup: bool = True,
               ) -> tuple[np.ndarray, np.ndarray]:
    """Generate an R-MAT edge list with ``2**scale`` vertices.

    Returns ``(src, dst)`` int32 arrays.  Self-loops are removed; with
    ``dedup`` duplicate edges collapse (the paper's datasets are simple
    graphs).  Fully vectorized bit-by-bit quadrant descent.
    """
    rng = np.random.default_rng(seed)
    n_edges = edge_factor << scale
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = rng.random(n_edges)
        right = (r >= a) & (r < ab)          # quadrant b: dst bit set
        down = (r >= ab) & (r < abc)         # quadrant c: src bit set
        both = r >= abc                      # quadrant d: both bits set
        src = (src << 1) | (down | both)
        dst = (dst << 1) | (right | both)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedup:
        key = (src << np.int64(scale)) | dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
    return src.astype(np.int32), dst.astype(np.int32)


def degree_bias(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                *, bias_bits: int = 16) -> np.ndarray:
    """Per-edge integer bias = destination degree, clipped to bias_bits.

    This is the paper's default: "we generate the bias ... based on the
    degree of vertices, which naturally follow power law" (§6.1).
    """
    deg = np.bincount(dst, minlength=num_vertices)
    return np.clip(deg[dst], 1, (1 << bias_bits) - 1).astype(np.int32)


def sample_bias(n: int, dist: str, *, bias_bits: int = 16,
                seed: int = 0) -> np.ndarray:
    """Bias vectors for the Fig. 15(c) distribution sweep.

    ``uniform`` | ``normal`` | ``exponential`` (the skewed cases), integer
    in [1, 2**bias_bits).
    """
    rng = np.random.default_rng(seed)
    hi = (1 << bias_bits) - 1
    if dist == "uniform":
        w = rng.integers(1, hi + 1, n)
    elif dist == "normal":
        w = np.rint(rng.normal(hi / 2, hi / 8, n))
    elif dist == "exponential":
        w = np.rint(rng.exponential(hi / 16, n))
    else:
        raise ValueError(f"unknown bias distribution {dist!r}")
    return np.clip(w, 1, hi).astype(np.int32)
