"""Mamba-1 selective-SSM block (jamba's recurrent layer).

Port of ``repro/models/ssm.py``.  The training path runs the discretized
SSM along time one step at a time, in the reference's float order, in
chunks of ``_CHUNK`` steps; with grad enabled each chunk runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint(chunk)``,
so the backward pass saves one (B, Di, N) state a chunk, not a step.
On DTensors the causal conv, the scan and the decode step run on each
rank's shard of the batch and the channels (``steps.on_shards``), and a
dry run costs the scan on a bounded number of chunks (``steps.loop``).
Decode keeps O(1) state — a (d_conv-1, Di) conv ring + a (Di, N) SSM
state.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.models import steps
from repro_torch.models.layers import dense_init, dot, silu

__all__ = ["init_mamba", "mamba_train", "mamba_decode", "init_mamba_cache"]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(gen: torch.Generator, cfg, dtype=torch.float32):
    D = cfg.d_model
    Di = cfg.mamba_d_inner
    N = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dtr = cfg.mamba_dt_rank
    dev = gen.device
    p = {
        "in_proj": dense_init(gen, (D, 2 * Di), dtype=dtype),
        "conv_w": dense_init(gen, (dc, Di), dtype=dtype),
        "conv_b": torch.zeros((Di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (Di, dtr + 2 * N), dtype=dtype),
        "dt_proj": dense_init(gen, (dtr, Di), dtype=dtype),
    }
    # S4D-real initialization for A; dt bias init for softplus ∈ [1e-3, 0.1]
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=dev).expand(Di, N)
    u = torch.rand((Di,), generator=gen, dtype=torch.float32, device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inv-softplus
    p.update({
        "dt_bias": dt_bias,
        "A_log": torch.log(A),
        "Dskip": torch.ones((Di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (Di, D), dtype=dtype),
    })
    return p


def _ssm_inputs(params, cfg, xz):
    """Shared projections: (x, res) halves of the input projection."""
    x, res = torch.chunk(xz, 2, dim=-1)
    return x, res


def _dt_bc(params, cfg, xc):
    N, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    dt = xc.dtype
    proj = dot(xc, params["x_proj"].to(dt))
    dt_r, B, C = torch.split(proj, [dtr, N, N], dim=-1)
    delta = _softplus(
        dot(dt_r, params["dt_proj"].to(dt)).to(torch.float32)
        + params["dt_bias"])
    return delta, B.to(torch.float32), C.to(torch.float32)


# xc (B, S, Di), conv_w (dc, Di), conv_b (Di,): the batch and channels
_CONV_SPECS = (("B", None, "C"), (None, "C"), ("C",))


def _causal_conv(xc, w, b):
    """The depthwise causal conv along S: (B, S, Di) by (dc, Di) taps,
    zero history before the first step."""
    S, dc, dt = xc.shape[1], w.shape[0], xc.dtype
    pad = F.pad(xc, (0, 0, dc - 1, 0))
    return sum(pad[:, i:i + S] * w[i].to(dt) for i in range(dc)) + b.to(dt)


_CHUNK = 64   # the reference's time-chunk length (S must divide by it)
# delta, dx (B, S, Di); B, C (B, S, N); A (Di, N): batch and channels
_SCAN_SPECS = (("B", None, "C"), ("B", None, "C"), ("B", None, None),
               ("B", None, None), ("C", None))


def mamba_train(params, cfg, x):
    """x: (B, S, D) -> (B, S, D); the selective scan, step by step."""
    S = x.shape[1]
    dt = x.dtype
    xz = dot(x, params["in_proj"].to(dt))                  # (B, S, 2Di)
    xc, res = _ssm_inputs(params, cfg, xz)

    # depthwise causal conv along S, whole on every rank: on DTensors, on
    # each rank's shard of the batch and the channels (steps.on_shards)
    conv = steps.on_shards(_causal_conv, (xc, params["conv_w"],
                                          params["conv_b"]),
                           _CONV_SPECS, (_CONV_SPECS[0],))
    xc = silu(conv.to(torch.float32)).to(dt)

    delta, Bs, Cs = _dt_bc(params, cfg, xc)                # (B,S,Di),(B,S,N)²
    A = -torch.exp(params["A_log"])                        # (Di, N)
    dx = delta * xc.to(torch.float32)                      # (B,S,Di)

    L = steps.chunk_len(min(_CHUNK, S))
    if S % L:
        raise ValueError("sequence must divide the mamba chunk length")

    def chunk(h, delta_c, dx_c, B_c, C_c, A):
        # one view a step: the backward stacks the steps' gradients once
        # (indexing [:, t] a step would zero-fill the chunk a step)
        ys = []
        for d_t, x_t, b_t, c_t in zip(delta_c.unbind(1), dx_c.unbind(1),
                                      B_c.unbind(1), C_c.unbind(1)):
            dA_t = torch.exp(d_t[:, :, None] * A)          # (B,Di,N)
            h = dA_t * h + x_t[:, :, None] * b_t[:, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, c_t))
        return h, torch.stack(ys, dim=1)

    if torch.is_grad_enabled():
        chunk = functools.partial(ckpt.checkpoint, chunk, use_reentrant=False)

    def body(c, carry, xs):
        delta, dx, Bs, Cs, A = xs
        t = slice(c * L, (c + 1) * L)
        h, y_c = chunk(carry[0], delta[:, t], dx[:, t], Bs[:, t], Cs[:, t], A)
        return (h,), (y_c,)

    def scan(delta, dx, Bs, Cs, A):
        # on one rank's shard of the batch and channels (steps.on_shards)
        h = torch.zeros(delta.shape[:1] + A.shape, dtype=torch.float32,
                        device=delta.device)
        _, ys = steps.loop(body, (h,), S // L, (delta, dx, Bs, Cs, A),
                           width=L)
        return torch.cat([y_c for (y_c,) in ys], dim=1)

    y = steps.on_shards(scan, (delta, dx, Bs, Cs, A), _SCAN_SPECS,
                        (("B", None, "C"),))                 # (B,S,Di)
    y = y + xc.to(torch.float32) * params["Dskip"]
    y = (y * silu(res.to(torch.float32))).to(dt)
    return dot(y, params["out_proj"].to(dt))


def init_mamba_cache(cfg, batch: int, dtype=torch.float32, device="cuda"):
    Di, N, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": torch.zeros((batch, dc - 1, Di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, Di, N), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(params, cfg, x, cache):
    """One-token step. x: (B, 1, D) -> ((B, 1, D), new cache)."""
    dt = x.dtype
    xz = dot(x[:, 0], params["in_proj"].to(dt))            # (B, 2Di)
    xc, res = torch.chunk(xz, 2, dim=-1)

    hist = torch.cat([cache["conv"].to(dt), xc[:, None]], 1)
    conv = (torch.einsum("bcd,cd->bd", hist, params["conv_w"].to(dt))
            + params["conv_b"].to(dt))
    new_conv = hist[:, 1:]
    xcs = silu(conv.to(torch.float32)).to(dt)

    delta, Bs, Cs = _dt_bc(params, cfg, xcs[:, None])
    delta, Bs, Cs = delta[:, 0], Bs[:, 0], Cs[:, 0]
    A = -torch.exp(params["A_log"])
    # on DTensors, on each rank's shard of the state (batch and channels)
    y, h = steps.on_shards(
        _ssm_step, (cache["ssm"], delta, xcs, Bs, Cs, A, params["Dskip"]),
        _STEP_SPECS, (("B", "C"), _STEP_SPECS[0]))
    y = (y * silu(res.to(torch.float32))).to(dt)
    out = dot(y, params["out_proj"].to(dt))[:, None]
    return out, {"conv": new_conv.to(cache["conv"].dtype), "ssm": h}


# the state (B, Di, N); delta, xc (B, Di); B, C (B, N); A (Di, N); the
# skip (Di,): the batch and the channels
_STEP_SPECS = (("B", "C", None), ("B", "C"), ("B", "C"), ("B", None),
               ("B", None), ("C", None), ("C",))


def _ssm_step(h, delta, xc, Bs, Cs, A, Dskip):
    """One step of the selective SSM's state -> (y (B, Di), h)."""
    dA = torch.exp(delta[..., None] * A)                   # (B,Di,N)
    h = dA * h + (delta * xc.to(torch.float32))[..., None] * Bs[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cs)
    return y + xc.to(torch.float32) * Dskip, h
