"""Shared layer primitives: norms, MLPs, rotary embeddings, initializers.

Port of ``repro/models/layers.py``, in its float order: the RMS norm
and the rotary angles in float32, the SwiGLU gate's SiLU in float32 and
cast back, SiLU spelled as the reference's ``x * sigmoid(x)``.
``dense_init`` draws from an explicit ``torch.Generator`` and allocates
on the generator's device; a truncated normal in [-2, 2]
standard deviations, as the reference's, but not its numbers (weights
carried over from the reference go through ``model.params_from_jax``).
"""

from __future__ import annotations

import torch

__all__ = ["rms_norm", "dense_init", "silu", "swiglu", "rope",
           "rope_partial", "init_mlp", "mlp"]


def dense_init(gen: torch.Generator, shape, scale: float = 1.0,
               dtype=torch.float32):
    """Truncated-normal fan-in init (stddev = scale / sqrt(fan_in))."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale / max(fan_in, 1) ** 0.5
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dt)


def silu(x):
    """``jax.nn.silu``'s spelling, which rounds as the reference does on
    more inputs than ``F.silu``."""
    return x * torch.sigmoid(x)


def swiglu(gate, up):
    return silu(gate.to(torch.float32)).to(gate.dtype) * up


def _rope_angles(positions, dim: int, theta: float):
    """(..., dim/2) rotary angles for integer positions."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    return positions[..., None].to(torch.float32) * freqs


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding over the full head dim. x: (B, S, H, dh)."""
    dh = x.shape[-1]
    ang = _rope_angles(positions, dh, theta)             # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def rope_partial(x, positions, fraction: float, theta: float = 10000.0):
    """Partial rotary (glm4): rotate the first ``fraction`` of head dims."""
    if fraction >= 1.0:
        return rope(x, positions, theta)
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    return torch.cat([rope(xr, positions, theta), xp], dim=-1)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32):
    return {
        "wg": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "wi": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "wo": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }


def mlp(params, x):
    """SwiGLU MLP. x: (..., D)."""
    dt = x.dtype
    gate = x @ params["wg"].to(dt)
    up = x @ params["wi"].to(dt)
    return swiglu(gate, up) @ params["wo"].to(dt)
