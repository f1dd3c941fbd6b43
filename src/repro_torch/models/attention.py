"""GQA attention block: RoPE variants, SWA, chunked-local, QKV bias, cache.

Port of ``repro/models/attention.py``.  Covers every assigned
transformer: full/partial/no rotary, sliding-window (mixtral), chunked
local + NoPE-global slots (llama4), QKV bias (qwen2), non-causal encoder
(hubert), and GQA KV head counts from 2 to 16.

Two paths share the math:
  * ``attention_train``  — full-sequence forward (training / prefill);
  * ``attention_decode`` — one-token step against a ring KV cache, which
    it writes in place (the port's counterpart of donation) and returns.
The inner product is the dense ``attention_ref`` / ``attention_ref_chunked``
of ``kernels/flash_attention.py``, the counterparts of what the
reference's model calls; no model path calls the flash kernel, in either
package.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (attention_ref,
                                                 attention_ref_chunked)
from repro_torch.models.layers import dense_init, rope_partial

_Q_CHUNK_THRESHOLD = 8192   # q-chunk long sequences (flash-like memory)

__all__ = ["init_attention", "attention_train", "attention_decode",
           "init_kv_cache"]


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32):
    D, H, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    p = {
        "wq": dense_init(gen, (D, H * dh), dtype=dtype),
        "wk": dense_init(gen, (D, Hkv * dh), dtype=dtype),
        "wv": dense_init(gen, (D, Hkv * dh), dtype=dtype),
        "wo": dense_init(gen, (H * dh, D),
                         scale=1.0 / (2 * cfg.num_layers) ** 0.5,
                         dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * dh), ("bk", Hkv * dh), ("bv", Hkv * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(params, cfg, x, positions, *, use_rope: bool):
    B, S, D = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if use_rope and cfg.rope_fraction > 0:
        q = rope_partial(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = rope_partial(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def _window_for_slot(cfg, slot: int) -> tuple[int, bool]:
    """(effective window, use_rope) for a stage slot."""
    if slot in cfg.global_attn_slots:
        return 0, False                       # global NoPE slot (llama4)
    if cfg.chunk_attn:
        return cfg.chunk_attn, True           # chunked local ≈ windowed
    return cfg.sliding_window, True


def attention_train(params, cfg, x, positions, slot: int = 0):
    """Full-sequence attention. x: (B, S, D) -> (B, S, D)."""
    window, use_rope = _window_for_slot(cfg, slot)
    q, k, v = _project_qkv(params, cfg, x, positions, use_rope=use_rope)
    B, S = x.shape[:2]
    if cfg.chunk_attn and window:
        # llama4 chunked-local: token t attends within its chunk only.
        out = _chunked_attention(q, k, v, cfg.chunk_attn, causal=cfg.causal)
    else:
        fn = attention_ref_chunked if S >= _Q_CHUNK_THRESHOLD \
            else attention_ref
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=cfg.causal, window=window)
        out = out.transpose(1, 2)
    return out.reshape(B, S, -1) @ params["wo"].to(x.dtype)


def _chunked_attention(q, k, v, chunk: int, *, causal: bool):
    """Exact chunk-diagonal attention: reshape to (B, n, c, ...) blocks."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    c = min(chunk, S)
    n = S // c
    if S % c:
        raise ValueError(
            "sequence must be chunk-aligned for chunked attention")
    # (B, S=n·c, ...) -> (B·n, c, ...): chunks are contiguous along S.
    qb = q.reshape(B * n, c, H, dh)
    kb = k.reshape(B * n, c, Hkv, dh)
    vb = v.reshape(B * n, c, Hkv, dh)
    fn = attention_ref_chunked if c >= _Q_CHUNK_THRESHOLD else attention_ref
    out = fn(qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
             causal=causal)
    return out.transpose(1, 2).reshape(B, S, H, dh)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, slot: int = 0,
                  dtype=torch.bfloat16, device="cuda"):
    """Ring KV cache for one attention layer.

    Window/chunk-bounded slots allocate only the window; global slots
    allocate ``max_len``.
    """
    window, _ = _window_for_slot(cfg, slot)
    T = min(max_len, window) if window else max_len
    Hkv, dh = cfg.num_kv_heads, cfg.dh
    return {
        "k": torch.zeros((batch, Hkv, T, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, Hkv, T, dh), dtype=dtype, device=device),
    }


def attention_decode(params, cfg, x, pos, cache, slot: int = 0):
    """One-token decode. x: (B, 1, D); pos: (B,) absolute positions.

    The cache is a ring buffer of length T: slot ``pos % T``, written in
    place; returns ``(out, cache)``.  Masking uses absolute positions
    reconstructed from the ring (valid entries are the last
    min(pos+1, T) tokens).
    """
    window, use_rope = _window_for_slot(cfg, slot)
    q, k, v = _project_qkv(params, cfg, x, pos[:, None], use_rope=use_rope)
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[2]
    pos = pos.to(torch.int64)
    widx = pos % T
    bidx = torch.arange(B, device=pos.device)
    ck[bidx, :, widx] = k[:, 0].to(ck.dtype)
    cv[bidx, :, widx] = v[:, 0].to(cv.dtype)

    # absolute position of ring slot t: the largest p <= pos with p%T == t
    tpos = torch.arange(T, device=pos.device)[None, :]    # (B, T) ring slots
    delta = (widx[:, None] - tpos) % T
    abs_pos = pos[:, None] - delta                        # (B, T)
    valid = abs_pos >= 0
    if window:
        valid &= abs_pos > pos[:, None] - window
    if cfg.chunk_attn and slot not in cfg.global_attn_slots:
        valid &= (abs_pos // cfg.chunk_attn) == (pos[:, None]
                                                 // cfg.chunk_attn)

    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    rep = H // Hkv
    # grouped-GQA einsum: never materializes rep-expanded KV
    qh = (q[:, 0].to(torch.float32) * dh ** -0.5).reshape(B, Hkv, rep, dh)
    logits = torch.einsum("bkrd,bktd->bkrt", qh, ck.to(torch.float32))
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrt,bktd->bkrd", p, cv.to(torch.float32)
                       ).to(x.dtype)
    out = out.reshape(B, 1, H * dh) @ params["wo"].to(x.dtype)
    return out, cache
