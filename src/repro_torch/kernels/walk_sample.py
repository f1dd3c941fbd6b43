"""The two-stage Bingo sample on walker rows: per-step kernels and plain form.

Port of ``repro/kernels/walk_sample.py``: ``sample_rows``/``uniform_pick``
(and ``kernels/ref.py:walk_sample_ref``) in plain PyTorch, and the entries
of the two per-step kernels, ``walk_sample`` (``walk_sample_pallas``) and
``walk_sample_uniform`` (``walk_sample_uniform_pallas``).  Stage (i) is the
alias pick over the Kin inter-group lanes, stage (ii) the exact pick of the
⌈u2·|G_k|⌉-th member of group k by a masked prefix count over the bias
row.  Bases > 2 add one digit-proportional acceptance coin with an exact
inverse-transform (ITS) fallback; the fp decimal group samples by ITS over
the ``frac`` row.  ``csrc/walk_sample.cuh`` runs the same sampler per warp,
inside the whole-walk kernel and the per-step kernel ``csrc/walk_sample.cu``.

The entries take the reference's gathered ``(B, ·)`` rows, or, with
``rows`` (B,) int32, the full ``(V, ·)`` state tables, of which walker b
reads row ``rows[b]`` in place (no ``(B, C)`` gather on the card).  CPU
tensors run the plain version (the gather, then ``sample_rows`` /
``uniform_pick``); CUDA tensors launch the kernel, counted in
``walk_sample.launches`` / ``walk_sample_uniform.launches``, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _fake

__all__ = ["its_pick", "sample_rows", "uniform_pick", "walk_sample_ref",
           "walk_sample_uniform_ref", "walk_sample", "walk_sample_uniform"]


def its_pick(w: torch.Tensor, x01: torch.Tensor):
    """Exact ITS lane pass: the first lane ``i`` with ``cumsum(w)[i] > x01·Σw``.

    ``w`` (B, C) non-negative, ``x01`` (B,) in [0, 1).  Returns ``(idx
    (B,) int64, total (B,) float32)`` with ``idx = min(#{i: c_i <= x},
    C-1)``.  Integer weights are summed in integers (exact, so the float
    compare sees the same values in any order).  Float weights are summed
    left to right, lane by lane: the order the walk kernel uses, since a
    float prefix sum depends on it.
    """
    C = w.shape[-1]
    if w.dtype.is_floating_point:
        c = torch.empty_like(w)
        acc = w[:, 0]
        c[:, 0] = acc
        for j in range(1, C):
            acc = acc + w[:, j]
            c[:, j] = acc
    else:
        c = torch.cumsum(w, dim=-1).to(torch.float32)
    total = c[:, -1]
    x = x01 * total
    idx = (c <= x[:, None]).sum(-1)
    return torch.clamp(idx, max=C - 1), total


def sample_rows(prob, alias, bias, nbr, deg, u, frac=None, *,
                base_log2: int = 1):
    """Two-stage Bingo sample on gathered rows.

    prob/alias (B, Kin) — Kin counts the K radix groups plus, in fp mode,
    the decimal group; bias/nbr (B, C) int32; deg (B,) int32; u (B, ≥3)
    uniforms, (B, ≥5) when ``base_log2 > 1`` or ``frac`` (B, C) is given
    (columns: alias bucket, alias coin, member pick, acceptance coin, ITS
    position).  Returns ``(nxt, slot, ok)`` each (B,); nxt/slot are -1
    where ``ok`` is False (empty sampling space).
    """
    B, Kin = prob.shape
    C = bias.shape[-1]
    dev = bias.device
    has_frac = frac is not None
    u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]

    # stage (i): alias pick over the Kin lanes
    i = torch.clamp((u0 * Kin).to(torch.int64), max=Kin - 1)
    p_i = prob.gather(1, i[:, None])[:, 0]
    a_i = alias.gather(1, i[:, None])[:, 0].to(torch.int64)
    k = torch.where(u1 < p_i, i, a_i)
    num_radix = Kin - 1 if has_frac else Kin
    kc = torch.clamp(k, max=num_radix - 1)

    # stage (ii): digit row of the chosen radix group
    colC = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    valid = colC < deg[:, None]
    dmask = (1 << base_log2) - 1
    dig = torch.where(valid, (bias >> (kc[:, None] * base_log2).to(torch.int32))
                      & dmask, 0)
    member = dig != 0
    gsize = member.sum(-1, dtype=torch.int32)
    target = torch.minimum((u2 * gsize.to(torch.float32)).to(torch.int32),
                           gsize - 1) + 1
    cum = torch.cumsum(member, dim=-1, dtype=torch.int32)
    hit = member & (cum == target[:, None])
    slot = torch.argmax(hit.to(torch.int32), dim=-1)            # first hit

    if base_log2 > 1:
        # digit-proportional acceptance (§9.2), exact ITS fallback
        u3, u4 = u[:, 3], u[:, 4]
        dig_c = dig.gather(1, slot[:, None])[:, 0]
        accept = u3 * float(dmask) < dig_c.to(torch.float32)
        slot_its, _ = its_pick(dig, u4)
        slot = torch.where(accept, slot, slot_its)
    ok = gsize > 0

    if has_frac:
        # decimal group (§4.3): exact ITS over the frac row
        is_dec = k == num_radix
        wf = torch.where(valid, frac, 0.0)
        slot_dec, total = its_pick(wf, u[:, 4])
        slot = torch.where(is_dec, slot_dec, slot)
        ok = torch.where(is_dec, total > 0, ok)

    nxt = nbr.gather(1, slot[:, None])[:, 0]
    return (torch.where(ok, nxt, -1), torch.where(ok, slot, -1).to(torch.int32),
            ok)


def uniform_pick(nbr, deg, u2):
    """Degree-based unbiased pick: slot = ⌊u2·deg⌋.

    ``nbr`` (B, C) int32, ``deg`` (B,) int32, ``u2`` (B,) in [0, 1).
    Returns ``(nxt, slot, ok)`` each (B,); -1 where deg == 0.
    """
    slot = torch.minimum((u2 * deg.to(torch.float32)).to(torch.int32), deg - 1)
    nxt = nbr.gather(1, torch.clamp(slot, min=0).to(torch.int64)[:, None])[:, 0]
    ok = deg > 0
    return torch.where(ok, nxt, -1), torch.where(ok, slot, -1), ok


def _gather(rows, *tables):
    if rows is None:
        return tables
    r = rows.to(torch.int64)
    return tuple(None if x is None else x[r] for x in tables)


def _check_u(u, base_log2, frac):
    if (base_log2 > 1 or frac is not None) and u.shape[-1] < 5:
        raise ValueError(
            f"extended sampling paths need u (B, 5); got (B, {u.shape[-1]})")


def walk_sample_ref(prob, alias, bias, nbr, deg, u, frac=None, *,
                    base_log2: int = 1, rows=None):
    """Plain ``walk_sample``: gather ``rows`` (when given), then
    ``sample_rows``.  Returns ``(nxt (B,), slot (B,))`` int32, -1 on
    empty rows."""
    _check_u(u, base_log2, frac)
    prob, alias, bias, nbr, deg, frac = _gather(rows, prob, alias, bias, nbr,
                                                deg, frac)
    nxt, slot, _ = sample_rows(prob, alias, bias, nbr, deg, u, frac,
                               base_log2=base_log2)
    return nxt, slot


def walk_sample_uniform_ref(nbr, deg, u, *, rows=None):
    """Plain ``walk_sample_uniform``: gather ``rows`` (when given), then
    ``uniform_pick`` on ``u[:, 0]``.  Returns ``(nxt, slot)`` int32."""
    nbr, deg = _gather(rows, nbr, deg)
    nxt, slot, _ = uniform_pick(nbr, deg, u[:, 0])
    return nxt, slot


def _batch(nbr, u, rows):
    """Walker count B and table height R (R == B without ``rows``)."""
    B = u.shape[0]
    if rows is not None:
        _build.check("rows", rows, torch.int32, (B,))
    elif nbr.shape[0] != B:
        raise ValueError(f"gathered rows: nbr has {nbr.shape[0]} rows, u {B}")
    return B, nbr.shape[0]


def _fake_pair(u, nbr):
    """``(nxt, slot)`` shapes on fake tensors (``_fake``)."""
    return tuple(torch.empty(u.shape[0], dtype=torch.int32, device=nbr.device)
                 for _ in range(2))


def walk_sample(prob, alias, bias, nbr, deg, u, frac=None, *,
                base_log2: int = 1, rows=None):
    """One two-stage Bingo sample per walker, dispatched by the device of
    ``nbr``.

    prob/alias (R, Kin) f32/i32 — Kin = K radix groups (+1 decimal group
    in fp mode, with ``frac`` (R, C) f32); bias/nbr (R, C) i32; deg (R,)
    i32; u (B, 3) uniforms, (B, 5) when ``base_log2 > 1`` or ``frac`` is
    given (alias bucket, alias coin, member pick, acceptance coin, ITS
    position).  R == B (gathered rows) unless ``rows`` (B,) int32 names
    each walker's row of the (V, ·) tables; every entry must lie in
    [0, V), which the kernel does not check.  Returns ``(nxt (B,), slot
    (B,))`` int32; -1 on empty rows.  Fake tensors launch nothing
    (``_fake``).
    """
    _check_u(u, base_log2, frac)
    if _fake.is_fake(nbr):
        _fake.record("walk_sample", walkers=u.shape[0], capacity=nbr.shape[1],
                     kin=prob.shape[1], fp=int(frac is not None),
                     ucols=u.shape[1])
        return _fake_pair(u, nbr)
    if nbr.device.type == "cpu":
        return walk_sample_ref(prob, alias, bias, nbr, deg, u, frac,
                               base_log2=base_log2, rows=rows)
    if nbr.device.type != "cuda":
        raise ValueError(f"walk_sample: no kernel for device {nbr.device}")
    B, R = _batch(nbr, u, rows)
    C, Kin = nbr.shape[1], prob.shape[1]
    _build.check("prob", prob, torch.float32, (R, Kin))
    _build.check("alias", alias, torch.int32, (R, Kin))
    _build.check("bias", bias, torch.int32, (R, C))
    _build.check("nbr", nbr, torch.int32, (R, C))
    _build.check("deg", deg, torch.int32, (R,))
    if frac is not None:
        _build.check("frac", frac, torch.float32, (R, C))
    ucols = u.shape[1]
    _build.check("u", u, torch.float32, (B, ucols))
    nxt = torch.empty(B, dtype=torch.int32, device=nbr.device)
    slot = torch.empty(B, dtype=torch.int32, device=nbr.device)
    lib = _build.library("walk_sample")
    err = lib.walk_sample_launch(
        *[_build.ptr(x) for x in (prob, alias, bias, nbr, deg, frac, u, rows,
                                  nxt, slot)],
        B, C, Kin, base_log2, int(frac is not None), ucols,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"walk_sample launch failed: {_build.error_string(err)}")
    walk_sample.launches += 1
    return nxt, slot


def walk_sample_uniform(nbr, deg, u, *, rows=None):
    """Unbiased degree pick per walker, dispatched by the device of ``nbr``.

    nbr (R, C) i32, deg (R,) i32, u (B, ≥1) uniforms (column 0 is used);
    R == B unless ``rows`` (B,) int32 names each walker's row.  Returns
    ``(nxt (B,), slot (B,))`` int32; -1 where the degree is 0.  Fake
    tensors launch nothing (``_fake``).
    """
    if _fake.is_fake(nbr):
        _fake.record("walk_sample_uniform", walkers=u.shape[0],
                     capacity=nbr.shape[1], kin=0, fp=0, ucols=u.shape[1])
        return _fake_pair(u, nbr)
    if nbr.device.type == "cpu":
        return walk_sample_uniform_ref(nbr, deg, u, rows=rows)
    if nbr.device.type != "cuda":
        raise ValueError(f"walk_sample_uniform: no kernel for device {nbr.device}")
    B, R = _batch(nbr, u, rows)
    C = nbr.shape[1]
    _build.check("nbr", nbr, torch.int32, (R, C))
    _build.check("deg", deg, torch.int32, (R,))
    ucols = u.shape[1]
    _build.check("u", u, torch.float32, (B, ucols))
    nxt = torch.empty(B, dtype=torch.int32, device=nbr.device)
    slot = torch.empty(B, dtype=torch.int32, device=nbr.device)
    lib = _build.library("walk_sample")
    err = lib.walk_sample_uniform_launch(
        *[_build.ptr(x) for x in (nbr, deg, u, rows, nxt, slot)], B, C, ucols,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"walk_sample_uniform launch failed: {_build.error_string(err)}")
    walk_sample_uniform.launches += 1
    return nxt, slot


walk_sample.launches = 0
walk_sample_uniform.launches = 0
