"""Attention forward: the dense reference, the flash algorithm, its kernels.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``)
and of the oracles ``kernels/ref.py:attention_ref`` and
``attention_ref_chunked``.  Layouts are the reference's: q (B, H, S, D),
k and v (B, Hkv, T, D), H a multiple of Hkv (grouped-query attention:
query head h reads KV head h // (H / Hkv)); query row i sits at position
``i + T - S``.  A key is seen when it is at or before the query (causal)
and, with ``window > 0``, fewer than ``window`` positions before it.

- ``attention_ref``: dense softmax attention through a grouped einsum
  (no repeated KV), masked logits at -inf, as the reference computes it.
- ``flash_attention_ref32``: the online-softmax algorithm all in float32
  whatever the input type: KV tiles of 64 in order, vectorised over all
  query rows, masked scores at -1e30, q cast to float32 and then scaled,
  as the Pallas body does; returns float32.  It is the plain version of
  the float32 kernel and the float32 reference a bfloat16 output is held
  against.
- ``flash_attention_ref``: the plain version of the kernel of the input's
  type: ``flash_attention_ref32`` in q's type for float32, and for
  bfloat16 and float16 the tensor-core kernel's roundings (``_plain16``):
  KV tiles of 128 keys up to D = 128, of 64 up to 256 and of 32 above (the
  kernel's ``kBlockK`` at the width D runs at), scores as float32 sums of the
  16-bit products, the scale folded into an exp2, l summed from the
  float32 p, P rounded to the input's type before P V, which sums in
  float32.
- ``flash_attention``: the wrapper.  CPU tensors run
  ``flash_attention_ref``; CUDA tensors launch ``csrc/flash_attention.cu``
  (float32: three TF32 products on the tensor cores at D = 64, 80, 128,
  256, 384 and 512; counted in ``flash_attention.launches``) or
  ``csrc/flash_attention_sm90.cu`` (bfloat16 and float16, wgmma, D = 64,
  128, 256, 384 and 512; counted in ``flash_attention_sm90.launches``);
  past D = 256 a block owns a slice of the output columns and computes S
  over the whole of D.  Any D ≤ 512 runs zero-padded to the next width of
  its route (``kernel_head_dim``, ``pad_head_dim``), and the card declines
  D > 512 and other types (``check_kernel_inputs``).  The float32 kernel
  agrees with its plain version entry by entry within 2e-5; a 16-bit
  output is held row by row against ``flash_attention_ref32`` (the limit
  is ``chip_smoke.py``'s ``flash_row_excess``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["attention_ref", "attention_ref_chunked", "flash_attention_ref32",
           "flash_attention_ref", "kernel_head_dim", "check_kernel_inputs",
           "pad_head_dim", "flash_attention", "MAX_HEAD_DIM"]

_BLOCK_K = 64                # KV tile of ref32
_NEG_INF = -1e30
_MAX_Q_TILES = 65535         # the kernels' grid height, in query tiles
_16BIT = (torch.bfloat16, torch.float16)
# the widths each route is built for; above 256 only multiples of 128,
# which split into column slices of equal width (16 bits: two of D / 2;
# float32 at 384 and 512: D / 128 of 128)
_WIDTHS = {torch.float32: (64, 80, 128, 256, 384, 512),
           torch.bfloat16: (64, 128, 256, 384, 512),
           torch.float16: (64, 128, 256, 384, 512)}
MAX_HEAD_DIM = 512


def _block_k16(D: int) -> int:
    """The 16-bit kernel's KV tile at the width a head dim D runs at: 128
    keys up to 128, 64 up to 256, 32 above (csrc/flash_attention_sm90.cu's
    kBlockK: past 256 the query tile alone is 96 or 128 KB of shared
    memory)."""
    return 128 if D <= 128 else 64 if D <= 256 else 32


def _block_q(dtype) -> int:
    """Query rows of one block of the kernel that runs ``dtype``: 128 in
    16 bits, 64 in float32."""
    return 128 if dtype in _16BIT else 64


def _mask(S: int, T: int, q_offset: int, causal: bool, window: int,
          kpos: torch.Tensor, device):
    """(S, len(kpos)) bool: which keys each query row sees, or None."""
    if not causal and not window:
        return None
    qpos = torch.arange(S, device=device)[:, None] + q_offset
    mask = torch.ones((S, kpos.numel()), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos
    if window:
        mask &= kpos[None, :] > qpos - window
    return mask


def attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                  q_offset=None):
    """Reference attention (B, H, S, D) x (B, Hkv, T, D) -> (B, H, S, D).

    q is scaled in its own type, as the reference does; the logits and the
    softmax are float32; ``q_offset`` (default T - S) places the queries.
    Rows that see no key are NaN.
    """
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = (D ** -0.5) if scale is None else scale
    # the scale in q's type, made on the device (a fill, not a host copy,
    # so a forward pass on the card never waits for the host)
    qg = (q * torch.full((), scale, dtype=q.dtype, device=q.device)
          ).reshape(B, Hkv, rep, S, D)
    logits = torch.einsum("bkrsd,bktd->bkrst", qg.to(torch.float32),
                          k.to(torch.float32))
    off = (T - S) if q_offset is None else q_offset
    mask = _mask(S, T, off, causal, window, torch.arange(T, device=q.device),
                 q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,bktd->bkrsd", p, v.to(torch.float32))
    return out.reshape(B, H, S, D).to(q.dtype)


def attention_ref_chunked(q, k, v, *, causal=True, window=0, scale=None,
                          q_chunk=1024, q_offset=None):
    """``attention_ref`` over query chunks of ``q_chunk`` rows, chunk i at
    ``q_offset = i * q_chunk`` as the reference places it (plus
    ``q_offset``, if given: the queries' first position, for a block of
    the sequence); the whole at once when S is not a multiple of the
    chunk."""
    S = q.shape[2]
    qc = min(q_chunk, S)
    if S % qc:
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)
    return torch.cat([attention_ref(q[:, :, i:i + qc], k, v, causal=causal,
                                    window=window, scale=scale,
                                    q_offset=(q_offset or 0) + i)
                      for i in range(0, S, qc)], dim=2)


def flash_attention_ref32(q, k, v, *, causal=True, window=0, scale=None):
    """Plain online-softmax attention in float32, KV tile by KV tile (see
    the module docstring).  Returns (B, H, S, D) float32."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = float(D ** -0.5) if scale is None else float(scale)
    dev = q.device
    qf = (q.to(torch.float32) * scale).reshape(B, Hkv, rep, S, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    m = torch.full((B, Hkv, rep, S, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, rep, S, D), dtype=torch.float32, device=dev)
    neg = torch.tensor(_NEG_INF, dtype=torch.float32, device=dev)
    for j0 in range(0, T, _BLOCK_K):
        kt, vt = kf[:, :, j0:j0 + _BLOCK_K], vf[:, :, j0:j0 + _BLOCK_K]
        s = torch.einsum("bkrsd,bktd->bkrst", qf, kt)
        mask = _mask(S, T, T - S, causal, window,
                     torch.arange(j0, j0 + kt.shape[2], device=dev), dev)
        if mask is not None:
            s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkrst,bktd->bkrsd", p, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, S, D)


def _plain16(q, k, v, causal, window, scale):
    """The 16-bit kernel's algorithm (see the module docstring); returns
    (B, H, S, D) in q's type."""
    B, H, S, D = q.shape
    dt = q.dtype
    bk = _block_k16(D)
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    dev = q.device
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32,
                     device=dev)
    qf = q.to(torch.float32).reshape(B, Hkv, rep, S, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    m = torch.full((B, Hkv, rep, S, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, rep, S, D), dtype=torch.float32, device=dev)
    neg = torch.tensor(_NEG_INF, dtype=torch.float32, device=dev)
    for j0 in range(0, T, bk):
        kt, vt = kf[:, :, j0:j0 + bk], vf[:, :, j0:j0 + bk]
        s = torch.einsum("bkrsd,bktd->bkrst", qf, kt) * c
        mask = _mask(S, T, T - S, causal, window,
                     torch.arange(j0, j0 + kt.shape[2], device=dev), dev)
        if mask is not None:
            s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p16 = p.to(dt).to(torch.float32)
        acc = acc * corr + torch.einsum("bkrst,bktd->bkrsd", p16, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, S, D).to(dt)


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """The plain version of the kernel of q's type (see the module
    docstring).  Returns (B, H, S, D) in q's type."""
    if q.dtype in _16BIT:
        D = q.shape[-1]
        scale = float(D ** -0.5) if scale is None else float(scale)
        return _plain16(q, k, v, causal, window, scale)
    return flash_attention_ref32(q, k, v, causal=causal, window=window,
                                 scale=scale).to(q.dtype)


def kernel_head_dim(D: int, dtype=torch.bfloat16) -> int:
    """The width the card's kernel for ``dtype`` runs a head dim ``D`` at:
    the least width it is built for that holds D, 64, 128, 256, 384 or 512
    in 16 bits, 64, 80, 128, 256, 384 or 512 in float32 (hubert-xlarge's
    D = 80 runs unpadded there).  Raises ``ValueError`` above
    ``MAX_HEAD_DIM`` (512): no kernel is built that wide (at 512 the
    16-bit query tile alone takes 128 of a block's 227 KB of shared
    memory, the float32 one 128 KB as loaded)."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} is outside "
                         f"1..{MAX_HEAD_DIM}, the widths the card's kernels "
                         "take")
    return next(w for w in _WIDTHS.get(dtype, _WIDTHS[torch.bfloat16])
                if D <= w)


def check_kernel_inputs(q, k, v) -> None:
    """Raise ``ValueError`` unless the card's kernels take q (B, H, S, D),
    k and v (B, Hkv, T, D): one type, float32, bfloat16 or float16;
    D ≤ ``MAX_HEAD_DIM``; H a multiple of Hkv; S within the grid."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if q.dtype not in _WIDTHS:
        raise ValueError(f"flash_attention: no kernel for {q.dtype}")
    kernel_head_dim(D, q.dtype)
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads over {Hkv} KV heads")
    if -(-S // _block_q(q.dtype)) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention: {S} query rows exceed the grid")
    _build.check("k", k, q.dtype, (B, Hkv, T, D))
    _build.check("v", v, q.dtype, (B, Hkv, T, D))


def pad_head_dim(fn, q, k, v, *, causal=True, window=0, scale=None):
    """``fn(q, k, v, causal=, window=, scale=)`` at the kernel's width:
    q, k and v zero-padded along D to ``kernel_head_dim(D, q.dtype)``,
    ``scale`` taken from the true D (default D^-0.5), the output cut back
    to D.
    Zero columns add exact zeros to every q·k, and zero columns of V give
    output columns that are cut off, so the result is the same function
    of the unpadded inputs."""
    D = q.shape[-1]
    width = kernel_head_dim(D, q.dtype)
    scale = float(D ** -0.5) if scale is None else float(scale)
    if width == D:
        return fn(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = (torch.nn.functional.pad(x, (0, width - D)) for x in (q, k, v))
    out = fn(q, k, v, causal=causal, window=window, scale=scale)
    return out[..., :D].contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None):
    """Attention forward, dispatched by the device and type of ``q``.

    q (B, H, S, D), k and v (B, Hkv, T, D), contiguous, one type (float32,
    bfloat16 or float16 on the card), D ≤ ``MAX_HEAD_DIM`` on the card (run
    zero-padded to the route's next width, ``pad_head_dim``).  Returns
    (B, H, S, D) in q's type.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    check_kernel_inputs(q, k, v)
    _build.check("q", q, q.dtype, q.shape)      # on the card, contiguous
    route = flash_attention_sm90 if q.dtype in _16BIT else \
        flash_attention_f32
    return pad_head_dim(route, q, k, v, causal=causal, window=window,
                        scale=scale)


def _aligned(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def flash_attention_f32(q, k, v, *, causal: bool, window: int, scale: float):
    """Launch ``csrc/flash_attention.cu`` on float32 CUDA tensors of width
    64, 80, 128, 256, 384 or 512 that ``flash_attention`` has checked;
    counted in ``flash_attention.launches``."""
    _aligned(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    err = lib.flash_attention_launch(
        *[_build.ptr(x) for x in (q, k, v, out)], B, H, Hkv, S, T, D,
        int(causal), int(window), scale,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {_build.error_string(err)}")
    flash_attention.launches += 1
    return out


def flash_attention_sm90(q, k, v, *, causal: bool, window: int, scale: float):
    """Launch ``csrc/flash_attention_sm90.cu`` on bfloat16 or float16 CUDA
    tensors of width 64, 128, 256, 384 or 512 that ``flash_attention`` has
    checked; the 16-bit route's launch count."""
    _aligned(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.library("flash_attention_sm90")
    err = lib.flash_attention_sm90_launch(
        *[_build.ptr(x) for x in (q, k, v, out)], B, H, Hkv, S, T, D,
        int(q.dtype == torch.float16), int(causal), int(window),
        scale * math.log2(math.e),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError("flash_attention (sm90) launch failed: "
                           f"{_build.error_string(err, 'flash_attention_sm90')}")
    flash_attention_sm90.launches += 1
    return out


flash_attention.launches = 0
flash_attention_sm90.launches = 0
