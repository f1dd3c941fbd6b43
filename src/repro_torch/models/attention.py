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
from repro_torch.models import steps
from repro_torch.models.layers import (dense_init, dot, local_parts,
                                       merge_last, placed, rope_partial,
                                       split_last)

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
    q = dot(x, params["wq"].to(dt))
    k = dot(x, params["wk"].to(dt))
    v = dot(x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = split_last(q, H, dh)                      # (B, S, H, dh)
    k = split_last(k, Hkv, dh)
    v = split_last(v, Hkv, dh)
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
    if type(q).__name__ == "DTensor":
        out = _attend_sharded(q, k, v, cfg, window)
    else:
        out = _attend(q, k, v, cfg, window)
    return dot(merge_last(out), params["wo"].to(x.dtype))


def _attend(q, k, v, cfg, window, q_offset=None):
    """(B, S, H, dh) queries over (B, T, Hkv, dh) keys -> (B, S, H, dh);
    ``q_offset``: the queries' first position (a block of the sequence;
    default: the keys' end)."""
    S = max(q.shape[1], k.shape[1])       # a block of queries: its keys'
    if cfg.chunk_attn and window:
        # llama4 chunked-local: token t attends within its chunk only.
        return _chunked_attention(q, k, v, cfg.chunk_attn, causal=cfg.causal)
    fn = attention_ref_chunked if S >= _Q_CHUNK_THRESHOLD else attention_ref
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=cfg.causal, window=window, q_offset=q_offset)
    return out.transpose(1, 2)


def _attend_sharded(q, k, v, cfg, window):
    """``_attend`` on DTensors, each rank on its shard: the batch over
    the FSDP axes, and over ``model`` the KV heads where they divide;
    else the query heads where they divide into whole GQA groups (each
    rank slices the KV heads its queries read from keys and values
    whole); else the queries' sequence (keys and values whole: each
    rank's block of queries sees every key it needs, at its offset)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed.sharding import fsdp_axes
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    B, S = q.shape[:2]
    T, Hkv = k.shape[1], k.shape[2]
    m = sizes.get("model", 1)
    pq = [Replicate() for _ in names]
    pkv = [Replicate() for _ in names]
    dp = [a for a in fsdp_axes(mesh) if a in sizes]
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    if B % n_dp or not dp:
        dp = ["data"] if "data" in sizes and B % sizes["data"] == 0 else []
    for a in dp:
        pq[names.index(a)] = pkv[names.index(a)] = Shard(0)
    by_seq = by_head = False
    H = q.shape[2]
    n, rep = H // m, H // Hkv
    if m > 1 and Hkv % m == 0:
        pq[names.index("model")] = pkv[names.index("model")] = Shard(2)
    elif m > 1 and H % m == 0 and (n % rep == 0 or rep % n == 0):
        pq[names.index("model")] = Shard(2)
        by_head = True
    elif m > 1 and S % m == 0 and _blocks_ok(cfg, window, S // m, S):
        pq[names.index("model")] = Shard(1)
        by_seq = True
    pq, pkv = placed(pq, mesh), placed(pkv, mesh)
    ql, kl, vl = local_parts(mesh, ((q, pq), (k, pkv), (v, pkv)))
    if by_head:                           # the KV heads of these queries
        a = mesh.get_coordinate()[names.index("model")] * n
        kv = slice(a // rep, (a + n - 1) // rep + 1)
        kl, vl = kl[:, :, kv], vl[:, :, kv]
    if not by_seq:
        return DTensor.from_local(_attend(ql, kl, vl, cfg, window), mesh, pq,
                                  run_check=False)
    s = S // m
    o = mesh.get_coordinate()[names.index("model")] * s
    out = DTensor.from_local(_attend_block(ql, kl, vl, cfg, window, o, T),
                             mesh, pq, run_check=False)
    # the sequence whole again: a view merging a batch and a sequence
    # sharded over two axes has no sharding rule that DTensor can follow
    return out.redistribute(mesh, pkv)


def _blocks_ok(cfg, window, s: int, S: int) -> bool:
    """Whether a block of ``s`` queries lines up with the attention's
    chunks (chunked-local slots): whole chunks, or within one."""
    if not (cfg.chunk_attn and window):
        return True
    c = min(cfg.chunk_attn, S)
    return s % c == 0 or c % s == 0


def _attend_block(q, k, v, cfg, window, o: int, T: int):
    """Queries ``[o, o + s)`` of the sequence over the whole keys."""
    s = q.shape[1]
    if cfg.chunk_attn and window:
        c = min(cfg.chunk_attn, T)
        if s % c == 0:                       # whole chunks: their own keys
            return _chunked_attention(q, k[:, o:o + s], v[:, o:o + s], c,
                                      causal=cfg.causal)
        cs = o // c * c                      # within one chunk: its keys
        fn = attention_ref_chunked if c >= _Q_CHUNK_THRESHOLD \
            else attention_ref
        out = fn(q.transpose(1, 2), k[:, cs:cs + c].transpose(1, 2),
                 v[:, cs:cs + c].transpose(1, 2), causal=cfg.causal,
                 q_offset=o - cs)
        return out.transpose(1, 2)
    return _attend(q, k, v, cfg, window, q_offset=o)


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


def _ring_write_sharded(c, new, widx):
    """``c[b, :, widx[b]] = new[b]`` on a DTensor cache (B, Hkv, T, dh),
    in place on each rank's shard: the rank whose block of T holds the
    slot writes it (DTensor has no in-place rule for the indexed write
    on a sharded cache)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = c.device_mesh
    pl = c.placements
    # the new rows and slots on the cache's batch and head shards
    pn = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
          for p in pl]
    pw = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in pl]
    nl = new.to(c.dtype).redistribute(mesh, pn).to_local()
    wl = widx.redistribute(mesh, pw).to_local()
    cl = c.to_local()
    t, o = cl.shape[2], 0
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):                 # the rank's offset in T
        if isinstance(p, Shard) and p.dim == 2:
            o = o * mesh.shape[i] + coord[i]
    wl = wl - o * t
    inside = (wl >= 0) & (wl < t)
    wl = wl.clamp(0, t - 1)
    bl = torch.arange(cl.shape[0], device=cl.device)
    cl[bl, :, wl] = torch.where(inside[:, None, None], nl, cl[bl, :, wl])


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
    if type(ck).__name__ == "DTensor":
        _ring_write_sharded(ck, k[:, 0], widx)
        _ring_write_sharded(cv, v[:, 0], widx)
    else:
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
    qh = split_last((q[:, 0].to(torch.float32) * dh ** -0.5).reshape(
        B, H * dh), Hkv, rep, dh)
    if type(ck).__name__ == "DTensor" and any(p.is_shard(1)
                                             for p in ck.placements):
        # KV heads split: each rank on its batch and heads of the cache
        # (DTensor cannot flatten a batch and a split head dim into the
        # products' rows)
        out = steps.on_shards(_decode_attend, (qh, ck, cv, valid),
                              _DECODE_SPECS, (_DECODE_SPECS[0],))
    else:
        out = _decode_attend(qh, ck, cv, valid)
    out = dot(merge_last(out.to(x.dtype), 3)[:, None],
              params["wo"].to(x.dtype))
    return out, cache


# queries (B, Hkv, rep, dh), cache (B, Hkv, T, dh) twice, valid (B, T)
_DECODE_SPECS = (("B", "C", None, None),) * 3 + (("B", None),)


def _decode_attend(qh, ck, cv, valid):
    """Grouped-GQA decode attention (never materializes rep-expanded KV):
    queries (B, Hkv, rep, dh) over a (B, Hkv, T, dh) ring cache, its
    slots ``valid`` (B, T) -> (B, Hkv, rep, dh) float32."""
    logits = torch.einsum("bkrd,bktd->bkrt", qh, ck.to(torch.float32))
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bkrt,bktd->bkrd", p, cv.to(torch.float32))
