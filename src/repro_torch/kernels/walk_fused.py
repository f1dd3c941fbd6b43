"""Whole-walk kernel: B walks of L steps in one launch, and its segment entry.

Port of ``repro/kernels/walk_fused.py`` (both entries of
``walk_fused_pallas``) and its oracles ``kernels/ref.py:walk_fused_ref``
and ``walk_segment_ref``.  ``walk_fused`` and ``walk_segment`` are the
wrappers: on CPU tensors they run the plain versions ``walk_fused_ref``
and ``walk_segment_ref``; on CUDA tensors they launch ``csrc/walk_fused.cu``
(a tile of lanes per biased walker, a thread per simple one, the step
loop inside the kernel, on a persistent grid that hands walkers out
through an int32 count; the segment entry first lists its live slots and
writes every slot's row, then walks only the live ones) and count the
launch in ``walk_fused.launches`` / ``walk_segment.launches``.

The segment entry is the walker relay's per-round kernel
(``distributed/relay.py``): walker b enters at step ``t0[b]``, draws the
stream of walker id ``wid[b]`` and exits with a ``(vertex, step)``
frontier record when it samples a remote neighbour, which the relay's
shard-local view encodes ``-(g + 2)`` in ``nbr``.

Uniforms are counter-based: step t of walker b draws ``uniforms_at(seed,
b, t)``, six float32 columns — alias bucket, alias coin, member pick,
acceptance coin, ITS position, PPR stop coin — built from chained murmur3
finalizers with logical shifts and wrapping multiplies.  Torch's ``>>``
on int32 is arithmetic, so the plain hash computes in int64 and masks to
32 bits.  Feeding ``u`` (L, B, 6) overrides the hash.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _fake
from repro_torch.kernels.walk_sample import sample_rows, uniform_pick

__all__ = ["NUM_UNIFORMS", "fmix32", "uniforms_at", "hash_uniforms",
           "walk_fused_ref", "walk_fused", "walk_segment_ref", "walk_segment"]

NUM_UNIFORMS = 6

_MASK = 0xFFFFFFFF
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_P_WID, _P_T, _P_COL = 0x9E3779B1, 0x7FEB352D, 0x846CA68B


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2^32`` for int64 ``x`` in [0, 2^32) without int64
    overflow: split ``m`` into 16-bit halves."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def uniforms_at(seed: int, wid: torch.Tensor, t, ncols: int = NUM_UNIFORMS):
    """Counter-based per-(walker, step) uniforms in [0, 1).

    ``seed`` a Python int (the int32 seed, any sign); ``wid`` integer
    tensor of walker ids; ``t`` int or integer tensor broadcastable to
    ``wid``.  Returns float32 of shape ``broadcast(wid, t) + (ncols,)``,
    bit-equal to the reference's ``walk_fused.uniforms_at``.
    """
    wid = torch.as_tensor(wid).to(torch.int64) & _MASK
    t = torch.as_tensor(t, device=wid.device).to(torch.int64) & _MASK
    h = fmix32((seed & _MASK) ^ _mul32(wid, _P_WID))
    h = fmix32(h ^ _mul32(t, _P_T))
    col = torch.arange(ncols, dtype=torch.int64, device=wid.device)
    h = fmix32(h[..., None] ^ _mul32(col, _P_COL))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniforms(seed: int, length: int, B: int, device="cuda"):
    """Materialized (L, B, 6) hash stream — what the kernel draws."""
    wid = torch.arange(B, dtype=torch.int64, device=device)[None, :]
    ts = torch.arange(length, dtype=torch.int64, device=device)[:, None]
    return uniforms_at(seed, wid, ts)


def _step(prob, alias, bias, nbr, deg, frac, cur, ut, base_log2, uniform):
    """One sample of every walker from row ``cur``: ``(deg[cur], nxt)``."""
    safe = torch.clamp(cur, 0, nbr.shape[0] - 1)
    d = deg[safe]
    if uniform:
        nxt, _, _ = uniform_pick(nbr[safe], d, ut[:, 2])
    else:
        fr = frac[safe] if frac is not None else None
        nxt, _, _ = sample_rows(prob[safe], alias[safe], bias[safe],
                                nbr[safe], d, ut, fr, base_log2=base_log2)
    return d, nxt


def walk_fused_ref(prob, alias, bias, nbr, deg, frac, starts, u=None, *,
                   base_log2: int = 1, stop_prob: float = 0.0,
                   uniform: bool = False, seed=None, length=None):
    """Plain whole walk: the L-step loop over fed (or hashed) uniforms.

    Tables are the full state's: prob/alias (V, Kin), bias/nbr (V, C),
    deg (V,), frac (V, C) or None.  ``starts`` (B,) int32.  ``u`` (L, B,
    ≥6) float32, or None to draw the hash stream of ``seed`` (an int).
    Walkers that stop (PPR coin, dead end) emit -1 from then on.
    Returns the (B, L+1) int32 path, column 0 = ``starts``.
    """
    B = starts.shape[0]
    dev = nbr.device
    if u is not None:
        if u.shape[-1] < NUM_UNIFORMS:
            raise ValueError(f"fed uniforms must be (L, B, 6); got {tuple(u.shape)}")
        length = u.shape[0]
    wid = torch.arange(B, dtype=torch.int64, device=dev)
    stop = torch.tensor(stop_prob, dtype=torch.float32, device=dev)
    cur = starts.to(torch.int64)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    cols = [starts.to(torch.int32)]
    for t in range(length):
        ut = u[t] if u is not None else uniforms_at(seed, wid, t)
        d, nxt = _step(prob, alias, bias, nbr, deg, frac, cur, ut, base_log2,
                       uniform)
        alive = alive & (d > 0)
        if stop_prob > 0.0:
            alive = alive & (ut[:, 5] >= stop)
        cols.append(torch.where(alive, nxt, -1).to(torch.int32))
        alive = alive & (nxt >= 0)
        cur = torch.where(alive, nxt.to(torch.int64), cur)
    return torch.stack(cols, dim=1)


def walk_segment_ref(prob, alias, bias, nbr, deg, frac, starts, t0, u=None,
                     wid=None, *, length: int, base_log2: int = 1,
                     stop_prob: float = 0.0, uniform: bool = False,
                     seed=None):
    """Plain segment walk: the windowed L-step loop.

    Walker b idles until step ``t0[b]`` (its start at path column ``t0``,
    earlier columns -1), then walks until it stops or samples a remote
    neighbour (an ``nbr`` value ``-(g + 2)``), where it exits with the
    frontier record ``(g, t + 1)``.  ``starts < 0`` is a free slot and a
    walker with ``t0 > length`` emits nothing.  Step t draws ``u[t]``
    (fed, (L, B, ≥6)) or ``uniforms_at(seed, wid[b], t)`` (``wid``
    default ``arange(B)``).  Returns ``(path (B, L+1), frontier (B, 2))``
    int32.
    """
    B, L = starts.shape[0], length
    dev = nbr.device
    if u is not None and u.shape[-1] < NUM_UNIFORMS:
        raise ValueError(f"fed uniforms must be (L, B, 6); got {tuple(u.shape)}")
    if wid is None:
        wid = torch.arange(B, dtype=torch.int64, device=dev)
    stop = torch.tensor(stop_prob, dtype=torch.float32, device=dev)
    starts = starts.to(torch.int64)
    t0 = t0.to(torch.int64)
    occupied = (starts >= 0) & (t0 <= L)
    alive = occupied & (t0 == 0)
    cur = torch.clamp(starts, min=0)
    fv = torch.full((B,), -1, dtype=torch.int64, device=dev)
    ft = torch.full((B,), -1, dtype=torch.int64, device=dev)
    cols = [torch.full((B,), -1, dtype=torch.int64, device=dev)]
    for t in range(L):
        ut = u[t] if u is not None else uniforms_at(seed, wid, t)
        d, nxt = _step(prob, alias, bias, nbr, deg, frac, cur, ut, base_log2,
                       uniform)
        nxt = nxt.to(torch.int64)
        alive = alive & (d > 0)
        if stop_prob > 0.0:
            alive = alive & (ut[:, 5] >= stop)
        emit = alive & (nxt >= 0)
        remote = alive & (nxt <= -2)
        cols.append(torch.where(emit, nxt, -1))
        fv = torch.where(remote, -nxt - 2, fv)
        ft = torch.where(remote, t + 1, ft)
        activate = occupied & (t0 == t + 1) & (t + 1 < L)
        cur = torch.where(activate, starts, torch.where(emit, nxt, cur))
        alive = emit | activate
    path = torch.stack(cols, dim=1)
    col = torch.arange(L + 1, device=dev)[None, :]
    path = torch.where((col == t0[:, None]) & occupied[:, None],
                       starts[:, None], path)
    return path.to(torch.int32), torch.stack([fv, ft], 1).to(torch.int32)


def _tables(prob, alias, bias, nbr, deg, frac, starts, u, length, uniform,
            seed):
    """Check the tables and walk arguments a walk kernel takes; returns
    ``(prob, alias, bias, frac, V, C, Kin, ucols)`` with the tables the
    uniform pick does not read set to None."""
    from repro_torch.kernels import _build
    V, C = nbr.shape
    B = starts.shape[0]
    _build.check("nbr", nbr, torch.int32, (V, C))
    _build.check("deg", deg, torch.int32, (V,))
    _build.check("starts", starts, torch.int32, (B,))
    Kin = 1
    if not uniform:
        Kin = prob.shape[1]
        _build.check("prob", prob, torch.float32, (V, Kin))
        _build.check("alias", alias, torch.int32, (V, Kin))
        _build.check("bias", bias, torch.int32, (V, C))
        if frac is not None:
            _build.check("frac", frac, torch.float32, (V, C))
    else:
        prob = alias = bias = frac = None
    ucols = 0
    if u is not None:
        ucols = u.shape[-1]
        if ucols < NUM_UNIFORMS:
            raise ValueError(f"fed uniforms must be (L, B, 6); got {tuple(u.shape)}")
        _build.check("u", u, torch.float32, (length, B, ucols))
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} is outside int32")
    return prob, alias, bias, frac, V, C, Kin, ucols


def _fake_walk(name, prob, nbr, frac, starts, length, uniform):
    """A walk kernel's ``(path, frontier)`` shapes on fake tensors, and
    its record (walkers, steps, row width, alias-row width, fp mode)."""
    B = starts.shape[0]
    _fake.record(name, walkers=B, length=length, capacity=nbr.shape[1],
                 kin=0 if uniform else prob.shape[1],
                 fp=int(frac is not None and not uniform))
    i32 = dict(dtype=torch.int32, device=nbr.device)
    return torch.empty((B, length + 1), **i32), torch.empty((B, 2), **i32)


def walk_fused(prob, alias, bias, nbr, deg, frac, starts, seed=0, u=None, *,
               length: int, base_log2: int = 1, stop_prob: float = 0.0,
               uniform: bool = False):
    """Whole-walk entry, dispatched by the device of ``nbr``.

    Same arguments as ``walk_fused_ref`` (``seed`` an int in int32 range,
    ``u`` optional fed uniforms).  CPU tensors run ``walk_fused_ref``;
    CUDA tensors launch ``csrc/walk_fused.cu``; anything else raises.
    ``uniform=True`` (the ``simple`` kind) reads only ``nbr``/``deg``.
    Fake tensors launch nothing (``_fake``).
    """
    if _fake.is_fake(nbr):
        return _fake_walk("walk_fused", prob, nbr, frac, starts, length,
                          uniform)[0]
    if nbr.device.type == "cpu":
        return walk_fused_ref(prob, alias, bias, nbr, deg, frac, starts, u,
                              base_log2=base_log2, stop_prob=stop_prob,
                              uniform=uniform, seed=seed, length=length)
    if nbr.device.type != "cuda":
        raise ValueError(f"walk_fused: no kernel for device {nbr.device}")
    from repro_torch.kernels import _build
    prob, alias, bias, frac, V, C, Kin, ucols = _tables(
        prob, alias, bias, nbr, deg, frac, starts, u, length, uniform, seed)
    B = starts.shape[0]
    path = torch.empty((B, length + 1), dtype=torch.int32, device=nbr.device)
    taken = torch.zeros(1, dtype=torch.int32, device=nbr.device)
    lib = _build.library("walk_fused")
    ptrs = [_build.ptr(x) for x in
            (prob, alias, bias, nbr, deg, frac, starts, u, path, taken)]
    err = lib.walk_fused_launch(
        *ptrs, B, V, C, Kin, length, base_log2, ctypes.c_float(stop_prob),
        int(uniform), int(frac is not None), ucols, int(seed),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"walk_fused launch failed: {_build.error_string(err)}")
    walk_fused.launches += 1
    return path


walk_fused.launches = 0


def walk_segment(prob, alias, bias, nbr, deg, frac, starts, t0, seed, u=None,
                 wid=None, *, length: int, base_log2: int = 1,
                 stop_prob: float = 0.0, uniform: bool = False):
    """Segment entry, dispatched by the device of ``nbr``.

    Same arguments as ``walk_segment_ref``: ``t0`` (B,) int32 start steps,
    ``seed`` an int in int32 range, ``u`` optional fed uniforms (L, B, 6),
    ``wid`` (B,) int32 slot → walker id map (default ``arange(B)``).  CPU
    tensors run ``walk_segment_ref``; CUDA tensors launch the segment entry
    of ``csrc/walk_fused.cu``; anything else raises.  Returns ``(path
    (B, L+1), frontier (B, 2))`` int32.  Fake tensors launch nothing
    (``_fake``).
    """
    if _fake.is_fake(nbr):
        return _fake_walk("walk_segment", prob, nbr, frac, starts, length,
                          uniform)
    if nbr.device.type == "cpu":
        return walk_segment_ref(prob, alias, bias, nbr, deg, frac, starts, t0,
                                u, wid, length=length, base_log2=base_log2,
                                stop_prob=stop_prob, uniform=uniform,
                                seed=seed)
    if nbr.device.type != "cuda":
        raise ValueError(f"walk_segment: no kernel for device {nbr.device}")
    from repro_torch.kernels import _build
    prob, alias, bias, frac, V, C, Kin, ucols = _tables(
        prob, alias, bias, nbr, deg, frac, starts, u, length, uniform, seed)
    B = starts.shape[0]
    if wid is None:
        wid = torch.arange(B, dtype=torch.int32, device=nbr.device)
    _build.check("t0", t0, torch.int32, (B,))
    _build.check("wid", wid, torch.int32, (B,))
    path = torch.empty((B, length + 1), dtype=torch.int32, device=nbr.device)
    frontier = torch.empty((B, 2), dtype=torch.int32, device=nbr.device)
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    key = (nbr.device.index, stream)
    work = _SEGMENT_WORK.get(key)
    if work is None or work.numel() < B + 3:
        work = _SEGMENT_WORK[key] = torch.zeros(B + 3, dtype=torch.int32,
                                                device=nbr.device)
    lib = _build.library("walk_fused")
    ptrs = [_build.ptr(x) for x in (prob, alias, bias, nbr, deg, frac, starts,
                                    t0, wid, u, path, frontier, work)]
    err = lib.walk_segment_launch(
        *ptrs, B, V, C, Kin, length, base_log2, ctypes.c_float(stop_prob),
        int(uniform), int(frac is not None), ucols, int(seed),
        ctypes.c_void_p(stream))
    if err != 0:
        del _SEGMENT_WORK[key]          # its counters may not be zero
        raise RuntimeError(f"walk_segment launch failed: {_build.error_string(err)}")
    walk_segment.launches += 1
    return path, frontier


walk_segment.launches = 0
# (device index, stream) -> the segment entry's int32 scratch: three
# counters, zero between launches (the kernel leaves them so), then the
# live-slot list; one per stream, so launches on two streams never share it
_SEGMENT_WORK: dict = {}
