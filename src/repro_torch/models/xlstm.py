"""xLSTM blocks — mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro/models/xlstm.py``.  mLSTM trains in its parallel
(attention-like) form and decodes with the O(1) recurrent form; both keep
the reference's stabiliser order (``m`` from a max over log-gates, the
gates exponentiated after subtracting it), so the two forms agree.  sLSTM
has no parallel form (its recurrence is nonlinear) and steps through time
in both modes.  Block layout follows xLSTM §4: mLSTM uses a
pre-up-projection (pf=2) gated residual block; sLSTM uses a post-up/down
(pf=4/3) block.  On DTensors the mLSTM's parallel form and decode step
run on each rank's shard of the batch and the heads, the sLSTM's time
loop on its shard of the batch, heads whole (``steps.on_shards``), and a
dry run costs that loop on a bounded number of steps (``steps.loop``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import steps
from repro_torch.models.layers import (dense_init, dot, grad_layout,
                                       merge_last, pin_batch, pointwise,
                                       rms_norm, silu, split_last)

__all__ = ["init_mlstm", "mlstm_train", "mlstm_decode", "init_mlstm_cache",
           "init_slstm", "slstm_apply", "init_slstm_cache"]


_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, in its spelling."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715
                                                     * (x * x * x))))
    return x * cdf


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg, dtype=torch.float32):
    D = cfg.d_model
    Di = int(cfg.xlstm_pf * D)
    H = cfg.num_heads
    dev = gen.device
    return {
        "w_up": dense_init(gen, (D, 2 * Di), dtype=dtype),
        "wq": dense_init(gen, (Di, Di), dtype=dtype),
        "wk": dense_init(gen, (Di, Di), dtype=dtype),
        "wv": dense_init(gen, (Di, Di), dtype=dtype),
        "w_if": dense_init(gen, (Di, 2 * H), dtype=torch.float32),
        "b_if": torch.cat([torch.zeros((H,), device=dev),
                           3.0 * torch.ones((H,), device=dev)]),
        "gn": torch.ones((Di,), dtype=torch.float32, device=dev),
        "w_down": dense_init(gen, (Di, D), dtype=dtype),
    }


def _mlstm_qkvif(params, x_in):
    """Projections shared by both forms. x_in: (B, S, Di).  On DTensors
    q, k and v hand x_in partial sums over ``model`` as gradients and
    the gates' product (its weight whole there) a whole one, taken as a
    partial sum too (``grad_layout``), so that the four are summed
    before the one reduction."""
    dt = x_in.dtype
    q = dot(x_in, params["wq"].to(dt))
    k = dot(x_in, params["wk"].to(dt))
    v = dot(x_in, params["wv"].to(dt))
    gates = dot(grad_layout(x_in, "partial").to(torch.float32),
                params["w_if"]) + params["b_if"]
    return q, k, v, gates


def _heads(x, H):
    B, S, Di = x.shape
    return split_last(x, H, Di // H).transpose(1, 2)      # (B,H,S,dh)


def mlstm_train(params, cfg, x):
    """Parallel (quadratic) stabilized mLSTM. x: (B, S, D) -> (B, S, D)."""
    H = cfg.num_heads
    dt = x.dtype
    up = dot(x, params["w_up"].to(dt))
    x_in, z = torch.chunk(up, 2, dim=-1)                   # (B,S,Di) each
    q, k, v, gates = _mlstm_qkvif(params, x_in)
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)  # (B,H,S,dh)
    ig = gates[..., :H].transpose(1, 2)                    # (B,H,S) log-i
    fg = pointwise(F.logsigmoid, gates[..., H:]).transpose(1, 2)  # log-f
    # each (batch, head) alone: on DTensors, on each rank's shard of both
    h = steps.on_shards(_mlstm_parallel, (qh, kh, vh, ig, fg),
                        _PARALLEL_SPECS, (_PARALLEL_SPECS[0],))
    # the group-norm over all Di: on DTensors, the heads gathered first
    h = pin_batch(merge_last(h.transpose(1, 2)))           # (B,S,Di)
    h = rms_norm(h.to(dt), params["gn"], cfg.norm_eps)     # head group-norm
    # z's gradient, whole over ``model``, taken as a partial sum as x_in's
    # is: the two are one gradient, the up projection's (``grad_layout``)
    out = h * silu(grad_layout(z, "partial").to(torch.float32)).to(dt)
    return dot(out, params["w_down"].to(dt))


# qh, kh, vh (B, H, S, dh); ig, fg (B, H, S): the batch and the heads
_PARALLEL_SPECS = (("B", "C", None, None),) * 3 + (("B", "C", None),) * 2


def _mlstm_parallel(qh, kh, vh, ig, fg):
    """The stabilized parallel form over (B, H, S, dh) heads and (B, H, S)
    log input and forget gates -> (B, H, S, dh) float32."""
    S, dh = qh.shape[2], qh.shape[3]
    cum = torch.cumsum(fg, dim=-1)                         # (B,H,S)
    # log D[t,s] = cum[t] - cum[s] + i[s]  for s <= t
    logD = cum[..., :, None] - cum[..., None, :] + ig[..., None, :]
    tril = torch.tril(torch.ones((S, S), dtype=torch.bool, device=qh.device))
    logD = logD.masked_fill(~tril, float("-inf"))
    m = torch.amax(logD, dim=-1)                           # (B,H,S) stabilizer
    Dmat = torch.exp(logD - m[..., None])

    Smat = torch.einsum("bhsd,bhtd->bhst", qh.to(torch.float32),
                        kh.to(torch.float32)) * dh ** -0.5
    W = Smat * Dmat
    denom = torch.maximum(torch.abs(W.sum(-1)), torch.exp(-m))   # (B,H,S)
    h = torch.einsum("bhst,bhtd->bhsd", W, vh.to(torch.float32))
    return h / denom[..., None]


def init_mlstm_cache(cfg, batch: int, device="cuda"):
    D = cfg.d_model
    H = cfg.num_heads
    dh = int(cfg.xlstm_pf * D) // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, dh, dh), **f32),
        "n": torch.zeros((batch, H, dh), **f32),
        "m": torch.full((batch, H), -1e30, **f32),
    }


def mlstm_decode(params, cfg, x, cache):
    """O(1) recurrent step. x: (B, 1, D) -> ((B, 1, D), new cache)."""
    B = x.shape[0]
    H = cfg.num_heads
    D = cfg.d_model
    Di = int(cfg.xlstm_pf * D)
    dh = Di // H
    dt = x.dtype
    up = dot(x, params["w_up"].to(dt))
    x_in, z = torch.chunk(up, 2, dim=-1)
    q, k, v, gates = _mlstm_qkvif(params, x_in)
    qh = split_last(q[:, 0], H, dh).to(torch.float32)
    kh = split_last(k[:, 0], H, dh).to(torch.float32) * dh ** -0.5
    vh = split_last(v[:, 0], H, dh).to(torch.float32)
    ig = gates[:, 0, :H]                                    # (B,H) log-i
    fg = pointwise(F.logsigmoid, gates[:, 0, H:])           # (B,H) log-f
    # on DTensors, on each rank's shard of the state (batch and heads):
    # the (B, H, dh, dh) memory stays where it is, the small vectors come
    # to it
    h, C, n, m_new = steps.on_shards(
        _mlstm_step, (cache["C"], cache["n"], cache["m"], qh, kh, vh, ig, fg),
        _STEP_SPECS, (_STEP_SPECS[1],) + _STEP_SPECS[:3])
    h = pin_batch(merge_last(h)[:, None])                  # (B,1,Di)
    h = rms_norm(h.to(dt), params["gn"], cfg.norm_eps)
    out = h * silu(z.to(torch.float32)).to(dt)
    return dot(out, params["w_down"].to(dt)), {"C": C, "n": n, "m": m_new}


# C (B, H, dh, dh), n (B, H, dh), m (B, H); qh, kh, vh (B, H, dh); ig, fg
# (B, H): the batch and the heads
_STEP_SPECS = (("B", "C", None, None), ("B", "C", None), ("B", "C")) \
    + (("B", "C", None),) * 3 + (("B", "C"),) * 2


def _mlstm_step(C, n, m, qh, kh, vh, ig, fg):
    """One recurrent step of the state (C, n, m) -> (h (B, H, dh), C, n,
    m)."""
    m_new = torch.maximum(fg + m, ig)
    fp = torch.exp(fg + m - m_new)[..., None]
    ip = torch.exp(ig - m_new)[..., None]
    C = fp[..., None] * C + \
        ip[..., None] * kh[..., :, None] * vh[..., None, :]
    n = fp * n + ip * kh
    num = torch.einsum("bhde,bhd->bhe", C, qh)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qh)),
                        torch.exp(-m_new))
    return num / den[..., None], C, n, m_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg, dtype=torch.float32):
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    dff = int(D * 4 / 3)
    dev = gen.device
    return {
        "w_x": dense_init(gen, (D, 4 * D), dtype=dtype),   # z,i,f,o from x
        "r_h": dense_init(gen, (H, dh, 4 * dh), dtype=dtype),  # block-diag
        "b": torch.cat([torch.zeros((2 * D,), device=dev),
                        3.0 * torch.ones((D,), device=dev),
                        torch.zeros((D,), device=dev)]),
        "gn": torch.ones((D,), dtype=torch.float32, device=dev),
        "w_up": dense_init(gen, (D, 2 * dff), dtype=dtype),
        "w_down": dense_init(gen, (dff, D), dtype=dtype),
    }


def init_slstm_cache(cfg, batch: int, device="cuda"):
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, H, dh), **f32),
        "n": torch.full((batch, H, dh), 1e-6, **f32),
        "h": torch.zeros((batch, H, dh), **f32),
        "m": torch.zeros((batch, H), **f32),
    }


_STATE = ("c", "n", "h", "m")
_STATE_SPECS = {"c": ("B", None, None), "n": ("B", None, None),
                "h": ("B", None, None), "m": ("B", None)}


def _slstm_cell(params, cfg, xt, state):
    """One sLSTM step. xt: (B, 4D) preactivations from x."""
    B = xt.shape[0]
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhd,hde->bhe", h, params["r_h"].to(torch.float32))
    pre = xt.to(torch.float32).reshape(B, H, 4 * dh) + rec + \
        params["b"].reshape(H, 4 * dh)
    z, i, f, o = torch.chunk(pre, 4, dim=-1)               # (B,H,dh) each
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    # exponential gates with per-head stabilizer state m
    i_max = torch.amax(i, dim=-1)                          # (B,H)
    m_new = torch.maximum(torch.amax(f, dim=-1) + m, i_max)
    ip = torch.exp(i - m_new[..., None])
    fp = torch.exp(f + m[..., None] - m_new[..., None])
    c_new = fp * c + ip * z
    n_new = torch.clamp(fp * n + ip, min=1e-6)
    h_new = o * (c_new / n_new)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_apply(params, cfg, x, cache=None):
    """sLSTM block: step the cell through time, then the pf=4/3 gated FFN.

    x: (B, S, D).  Returns (out, state) — the final cell state (the
    decode state; S=1 performs exactly one step).
    """
    B, S, D = x.shape
    dt = x.dtype
    pre = dot(x, params["w_x"].to(dt))                     # (B,S,4D)

    def body(t, carry, xs):
        pre, r_h, b = xs
        state = _slstm_cell({"r_h": r_h, "b": b}, cfg, pre[:, t],
                            dict(zip(_STATE, carry)))
        return tuple(state[k] for k in _STATE), (state["h"],)

    def run(pre, r_h, b, *state):
        # on one rank's shard of the batch (steps.on_shards)
        if not state:
            st = init_slstm_cache(cfg, pre.shape[0], pre.device)
            state = tuple(st[k] for k in _STATE)
        state, hs = steps.loop(body, state, S, (pre, r_h, b))
        return (torch.stack([h for (h,) in hs], dim=1),) + tuple(state)

    given = () if cache is None else tuple(cache[k] for k in _STATE)
    out = steps.on_shards(
        run, (pre, params["r_h"], params["b"]) + given,
        (("B", None, None), (None,) * 3, (None,))
        + tuple(_STATE_SPECS[k] for k in _STATE[:len(given)]),
        (("B", None, None, None),) + tuple(_STATE_SPECS[k] for k in _STATE))
    state = dict(zip(_STATE, out[1:]))
    h = merge_last(out[0])                        # (B,S,H,dh) -> (B,S,D)
    h = rms_norm(h.to(dt), params["gn"], cfg.norm_eps)
    up = dot(h, params["w_up"].to(dt))
    g, u = torch.chunk(up, 2, dim=-1)
    out = dot(_gelu(g.to(torch.float32)).to(dt) * u, params["w_down"].to(dt))
    return out, state
