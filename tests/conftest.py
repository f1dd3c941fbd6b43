"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see the single real CPU device; only launch/dryrun.py forces 512 hosts."""

import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core.dyngraph import BingoConfig, from_edges


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop compiled-program caches between test modules — the suite
    compiles hundreds of programs and XLA's host allocations otherwise
    accumulate to an abort on this 1-core container."""
    yield
    jax.clear_caches()
    gc.collect()


def tiny_graph():
    """The paper's running example around vertex 2 + filler edges."""
    src = np.array([2, 2, 2, 0, 1, 3, 4, 5], np.int32)
    dst = np.array([1, 4, 5, 2, 2, 2, 2, 2], np.int32)
    w = np.array([5, 4, 3, 1, 2, 3, 4, 5], np.int32)
    return src, dst, w


@pytest.fixture(scope="session")
def tiny_state():
    cfg = BingoConfig(num_vertices=8, capacity=8, bias_bits=5)
    src, dst, w = tiny_graph()
    return from_edges(cfg, src, dst, w), cfg


def empirical_dist(samples, n):
    counts = np.bincount(np.asarray(samples), minlength=n)
    return counts / counts.sum()


def tv_distance(p, q):
    return 0.5 * float(np.abs(np.asarray(p) - np.asarray(q)).sum())


class HostRef:
    """Slot-accurate host simulator mirroring the device implementation.

    Inserts append to the row tail (capacity-checked); streaming deletes
    remove the earliest *slot* match via swap-with-tail (paper Fig. 6);
    batched deletes mark the earliest occurrences then compact (Fig. 10(b)).
    """

    def __init__(self, V, C, edges=()):
        self.C = C
        self.rows = {u: [] for u in range(V)}
        for u, v, w in edges:
            self.insert(u, v, w)

    def insert(self, u, v, w):
        if len(self.rows[u]) < self.C:
            self.rows[u].append((v, w))
            return True
        return False

    def delete(self, u, v):
        row = self.rows[u]
        for i, (vv, _) in enumerate(row):
            if vv == v:
                row[i] = row[-1]
                row.pop()
                return True
        return False

    def delete_batched(self, deletes):
        from collections import Counter
        want = Counter(deletes)
        for (u, v), m in want.items():
            row = self.rows[u]
            marked = 0
            for i in range(len(row)):
                if row[i] is not None and row[i][0] == v and marked < m:
                    row[i] = None
                    marked += 1
            self.rows[u] = [e for e in row if e is not None]

    def edges(self):
        return sorted((u, v, w) for u, r in self.rows.items()
                      for (v, w) in r)


def random_graph(V, C, *, max_bias=31, seed=0, density=0.6):
    """Random padded graph guaranteed to fit capacity."""
    rng = np.random.default_rng(seed)
    srcs, dsts, ws = [], [], []
    for u in range(V):
        d = int(rng.integers(1, max(2, int(C * density))))
        nbrs = rng.choice(V, size=d, replace=False)
        srcs += [u] * d
        dsts += list(nbrs)
        ws += list(rng.integers(1, max_bias + 1, d))
    return (np.array(srcs, np.int32), np.array(dsts, np.int32),
            np.array(ws, np.int32))
