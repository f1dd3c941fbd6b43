"""Whole-walk kernel: B walks of L steps in one launch.

Port of ``repro/kernels/walk_fused.py`` (whole-walk entry of
``walk_fused_pallas``) and its oracle ``kernels/ref.py:walk_fused_ref``.
``walk_fused`` is the wrapper: on CPU tensors it runs the plain version
``walk_fused_ref``; on CUDA tensors it launches ``csrc/walk_fused.cu`` (one
warp per walker, the step loop inside the kernel) and counts the launch in
``walk_fused.launches``.

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

from repro_torch.kernels.walk_sample import sample_rows, uniform_pick

__all__ = ["NUM_UNIFORMS", "fmix32", "uniforms_at", "hash_uniforms",
           "walk_fused_ref", "walk_fused"]

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
    V = nbr.shape[0]
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
        safe = torch.clamp(cur, 0, V - 1)
        d = deg[safe]
        if uniform:
            nxt, _, _ = uniform_pick(nbr[safe], d, ut[:, 2])
        else:
            fr = frac[safe] if frac is not None else None
            nxt, _, _ = sample_rows(prob[safe], alias[safe], bias[safe],
                                    nbr[safe], d, ut, fr, base_log2=base_log2)
        alive = alive & (d > 0)
        if stop_prob > 0.0:
            alive = alive & (ut[:, 5] >= stop)
        cols.append(torch.where(alive, nxt, -1).to(torch.int32))
        alive = alive & (nxt >= 0)
        cur = torch.where(alive, nxt.to(torch.int64), cur)
    return torch.stack(cols, dim=1)


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous CUDA tensor")


def walk_fused(prob, alias, bias, nbr, deg, frac, starts, seed=0, u=None, *,
               length: int, base_log2: int = 1, stop_prob: float = 0.0,
               uniform: bool = False):
    """Whole-walk entry, dispatched by the device of ``nbr``.

    Same arguments as ``walk_fused_ref`` (``seed`` an int in int32 range,
    ``u`` optional fed uniforms).  CPU tensors run ``walk_fused_ref``;
    CUDA tensors launch ``csrc/walk_fused.cu``; anything else raises.
    ``uniform=True`` (the ``simple`` kind) reads only ``nbr``/``deg``.
    """
    if nbr.device.type == "cpu":
        return walk_fused_ref(prob, alias, bias, nbr, deg, frac, starts, u,
                              base_log2=base_log2, stop_prob=stop_prob,
                              uniform=uniform, seed=seed, length=length)
    if nbr.device.type != "cuda":
        raise ValueError(f"walk_fused: no kernel for device {nbr.device}")
    from repro_torch.kernels import _build
    V, C = nbr.shape
    B = starts.shape[0]
    _check("nbr", nbr, torch.int32, (V, C))
    _check("deg", deg, torch.int32, (V,))
    _check("starts", starts, torch.int32, (B,))
    Kin = 1
    if not uniform:
        Kin = prob.shape[1]
        _check("prob", prob, torch.float32, (V, Kin))
        _check("alias", alias, torch.int32, (V, Kin))
        _check("bias", bias, torch.int32, (V, C))
        if frac is not None:
            _check("frac", frac, torch.float32, (V, C))
    else:
        prob = alias = bias = frac = None
    ucols = 0
    if u is not None:
        ucols = u.shape[-1]
        if ucols < NUM_UNIFORMS:
            raise ValueError(f"fed uniforms must be (L, B, 6); got {tuple(u.shape)}")
        _check("u", u, torch.float32, (length, B, ucols))
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} is outside int32")
    path = torch.empty((B, length + 1), dtype=torch.int32, device=nbr.device)
    lib = _build.library("walk_fused")
    ptrs = [_build.ptr(x) for x in
            (prob, alias, bias, nbr, deg, frac, starts, u, path)]
    err = lib.walk_fused_launch(
        *ptrs, B, V, C, Kin, length, base_log2, ctypes.c_float(stop_prob),
        int(uniform), int(frac is not None), ucols, int(seed),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"walk_fused launch failed: {_build.error_string(err)}")
    walk_fused.launches += 1
    return path


walk_fused.launches = 0
