"""The two-stage Bingo sample on ``(B, ·)`` walker rows, in plain form.

Port of ``repro/kernels/walk_sample.py:sample_rows``/``uniform_pick``
(and ``kernels/ref.py:walk_sample_ref``): stage (i) is the alias pick
over the Kin inter-group lanes, stage (ii) the exact pick of the
⌈u2·|G_k|⌉-th member of group k by a masked prefix count over the bias
row.  Bases > 2 add one digit-proportional acceptance coin with an exact
inverse-transform (ITS) fallback; the fp decimal group samples by ITS over
the ``frac`` row.  This is the sampler that ``csrc/walk_fused.cu`` runs
per step, written out for the CPU and as the kernel's plain version.  The
per-step CUDA kernel comes in a later slice.
"""

from __future__ import annotations

import torch

__all__ = ["its_pick", "sample_rows", "uniform_pick"]


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
