"""Attention (``kernels/flash_attention.py``) against JAX's reference.

The same q, k and v, built once in numpy (16-bit inputs rounded once by
JAX and handed to torch bit for bit), go through JAX's
``ref.attention_ref`` and through the port's ``ops.flash_attention`` on
CPU tensors (its plain version, ``flash_attention_ref``) and the port's
``attention_ref``, at ``atol`` 2e-5 in float32, 2e-2 in bfloat16 and 1e-2
in float16 (an output of size about 1 is rounded to 2^-11 there, the P
the plain version rounds to float16 to 2^-12 of its row's largest p; the
largest difference over this file's float16 cases is 2^-10, one float16
step at 1).  JAX's
``flash_attention_pallas`` cannot run with the installed JAX (it calls
``pltpu.TPUCompilerParams``, which JAX 0.9 does not have), so JAX's dense
reference is the oracle, as it is for the JAX package's own kernel test.
The cases are that test's (MHA, GQA 4:1, S < T, D = 128, windows 32 and
128, non-causal) plus a ragged S = T = 200, the wide heads the card
takes up to 512 (D = 160, run zero-padded to 256, and 256 itself, as
Gemma 2's 256-wide heads; D = 320, run zero-padded to 384, and 512, where
the card splits the output columns over blocks; causal, windowed,
non-causal and S < T, in all three types), and the head dims the card
runs zero-padded (``pad_head_dim``): hubert-xlarge's D = 80, D = 200,
300 and 400 and the SMOKE configs' D = 16 and 8.  In bfloat16 and
float16 the plain version is the tensor-core kernel's algorithm
(``_plain16``, its KV tile 64 keys above D = 128, 32 above 256); the
all-float32 ``flash_attention_ref32`` is held at 2e-5 in float32, and
``chip_smoke.py``'s row-wise bfloat16 limit must pass the plain bfloat16
algorithm and reject it one KV tile off at the band's edge.  The float32
kernel's arithmetic, three TF32 products for each of Q K^T and P V
(operands split into hi = rna(x) and lo = rna(x - hi), ten mantissa bits
rounded to nearest, ties away, as ``cvt.rna.tf32.f32`` does), is emulated
here over the kernel's KV tiles and held against JAX's dense reference at
the float32 atol; one TF32 product alone misses it.
"""

import math

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                 attention_ref,
                                                 attention_ref_chunked,
                                                 check_kernel_inputs,
                                                 flash_attention_ref,
                                                 flash_attention_ref32,
                                                 kernel_head_dim,
                                                 pad_head_dim)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import flash_row_excess, shifted_window  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 1e-2}
DTYPES = ["float32", "bfloat16", "float16"]
# head dims above 128 (160 runs padded to 256, 320 to 384)
WIDE = (160, 256, 320, 512)


def _inputs(shape_q, shape_kv, dtype, seed):
    """(jax q, k, v), (torch q, k, v): the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    if dtype == "float32":
        tx = [torch.from_numpy(a) for a in arrs]
    else:
        tx = [torch.from_numpy(np.asarray(j).view(np.int16).copy())
              .view(getattr(torch, dtype)) for j in jx]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _check(jx, tx, dtype, **kw):
    want = ref.attention_ref(*jx, **kw)
    before = ops.launch_counts()
    got = ops.flash_attention(*tx, **kw)
    assert ops.launch_counts() == before         # CPU tensors: plain version
    dense = attention_ref(*tx, **kw)
    assert got.dtype == dense.dtype == tx[0].dtype
    assert got.shape == tx[0].shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(dense), _f32(want), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,H,Hkv,S,T,D",
    [
        (1, 4, 4, 128, 128, 64),     # MHA square
        (2, 8, 2, 128, 128, 64),     # GQA 4:1
        (1, 4, 4, 64, 256, 64),      # S < T: q_offset = T - S
        (1, 2, 1, 256, 256, 128),    # D = 128
        (1, 4, 2, 200, 200, 64),     # ragged: a partial KV tile
        (1, 4, 2, 200, 200, 160),    # wide, padded to 256 on the card
        (1, 4, 2, 96, 200, 256),     # 256 wide, S < T, GQA
    ])
def test_flash_attention_matches_jax(B, H, Hkv, S, T, D, dtype):
    jx, tx = _inputs((B, H, S, D), (B, Hkv, T, D), dtype, S + T + H)
    _check(jx, tx, dtype, causal=True)


@pytest.mark.parametrize("window,D,dtype", [
    pytest.param(32, 64, "float32", id="32"),
    pytest.param(128, 64, "float32", id="128")] + [
    pytest.param(w, D, dt, id=f"{w}-{D}-{dt}")
    for w in (32, 128) for D in WIDE for dt in DTYPES])
def test_flash_attention_sliding_window_matches_jax(window, D, dtype):
    jx, tx = _inputs((1, 2, 256, D), (1, 2, 256, D), dtype, window + D)
    _check(jx, tx, dtype, causal=True, window=window)


def test_flash_attention_noncausal_matches_jax():
    jx, tx = _inputs((1, 2, 128, 64), (1, 2, 128, 64), "float32", 1)
    _check(jx, tx, "float32", causal=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", WIDE)
def test_flash_attention_noncausal_wide_matches_jax(D, dtype):
    """Non-causal at the wide head dims, GQA 2:1, S < T."""
    jx, tx = _inputs((1, 4, 96, D), (1, 2, 160, D), dtype, D)
    _check(jx, tx, dtype, causal=False)


def test_flash_attention_window_with_offset_matches_jax():
    """A window and S < T together, with GQA."""
    jx, tx = _inputs((1, 4, 72, 64), (1, 2, 200, 64), "float32", 9)
    _check(jx, tx, "float32", causal=True, window=50)


def test_attention_ref_chunked_matches_jax():
    jx, tx = _inputs((1, 4, 256, 64), (1, 2, 256, 64), "float32", 3)
    want = ref.attention_ref_chunked(*jx, causal=True, window=96, q_chunk=64)
    got = attention_ref_chunked(*tx, causal=True, window=96, q_chunk=64)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


PLAIN_CASES = [   # (B, H, Hkv, S, T, D, causal, window): the file's cases
    (1, 4, 4, 128, 128, 64, True, 0),        # MHA square
    (2, 8, 2, 128, 128, 64, True, 0),        # GQA 4:1
    (1, 4, 4, 64, 256, 64, True, 0),         # S < T
    (1, 2, 1, 256, 256, 128, True, 0),       # D = 128
    (1, 4, 2, 200, 200, 64, True, 0),        # ragged: a partial KV tile
    (1, 2, 2, 256, 256, 64, True, 32),       # windows
    (1, 2, 2, 256, 256, 64, True, 128),
    (1, 4, 2, 72, 200, 64, True, 50),        # a window with S < T and GQA
    (1, 2, 2, 128, 128, 64, False, 0),       # non-causal
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PLAIN_CASES + [
    (1, 4, 2, 200, 200, 256, True, 0),       # 256 wide: KV tiles of 64
    (1, 2, 2, 256, 256, 256, True, 96),
    (1, 2, 2, 128, 128, 256, False, 0),
    (1, 4, 2, 200, 200, 320, True, 0),       # past 256: KV tiles of 32
    (1, 2, 2, 256, 256, 320, True, 96),
    (1, 2, 2, 128, 128, 512, False, 0),
    (1, 4, 2, 96, 200, 512, True, 64)], ids=lambda c: "-".join(
        str(x) for x in c))
def test_plain_versions_match_jax(case, dtype):
    """Against JAX's dense reference at the file's atol: in bf16 and f16
    the tensor-core kernel's plain version (P rounded to the input's type
    before P V, the scale folded into exp2, KV tiles of 128, or 64 above
    D = 128, 32 above 256); in f32 the all-f32 ``flash_attention_ref32``, the reference
    a 16-bit output is held against."""
    B, H, Hkv, S, T, D, causal, window = case
    jx, tx = _inputs((B, H, S, D), (B, Hkv, T, D), dtype, S + T + H)
    want = ref.attention_ref(*jx, causal=causal, window=window)
    plain = flash_attention_ref if dtype != "float32" else \
        flash_attention_ref32
    got = plain(*tx, causal=causal, window=window)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
def test_bf16_limit_rejects_a_tile_shift(causal, window):
    """``chip_smoke.py``'s row-wise bf16 limit: the plain bf16 algorithm
    passes it against the f32 reference, and the same algorithm run with
    its window one tile off at the band's edge (``shifted_window``)
    fails it."""
    _limit_rejects_a_tile_shift(causal, window, 64, "bfloat16")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
def test_16bit_limit_rejects_a_tile_shift_at_256(causal, window, dtype):
    """The same limit at D = 256 (KV tiles of 64) in both 16-bit types."""
    _limit_rejects_a_tile_shift(causal, window, 256, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
def test_16bit_limit_rejects_a_tile_shift_at_512(causal, window, dtype):
    """The same limit at D = 512 (KV tiles of 32) in both 16-bit types."""
    _limit_rejects_a_tile_shift(causal, window, 512, dtype)


def _limit_rejects_a_tile_shift(causal, window, D, dtype):
    B, H, Hkv, S, T = 1, 4 if D <= 128 else 2, 2 if D <= 128 else 1, 256, 256
    _, (q, k, v) = _inputs((B, H, S, D), (B, Hkv, T, D), dtype, 7)
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    ref32 = flash_attention_ref32(q, k, v, causal=causal, window=window)
    fault = flash_attention_ref(q, k, v, causal=causal,
                                window=shifted_window(T, window))
    assert flash_row_excess(plain, plain, ref32) <= 1
    assert flash_row_excess(fault, plain, ref32) > 1


PAD_CASES = [   # (B, H, Hkv, S, T, D, causal, window): widths run padded
    (1, 16, 16, 128, 128, 80, False, 0),     # hubert-xlarge: MHA, 1280/16
    (1, 4, 2, 200, 200, 16, True, 0),        # xlstm SMOKE: 64/4, ragged
    (2, 8, 8, 128, 128, 8, True, 32),        # the SMOKE configs: 64/8
    (1, 4, 2, 200, 200, 200, True, 64),      # 200: padded to 256
    (1, 2, 1, 128, 160, 136, False, 0),      # 136: padded to 256
    (1, 4, 2, 200, 200, 300, True, 64),      # 300: padded to 384
    (1, 2, 1, 96, 160, 400, False, 0),       # 400: padded to 512, S < T
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PAD_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_padded_head_dims_match_jax(case, dtype):
    """The card's route for a head dim it has no kernel for: q, k and v
    zero-padded to ``kernel_head_dim(D)``, the plain version of the
    kernel of the type at that width, the output cut back to D; against
    JAX's dense reference at the true D, at the file's atol."""
    B, H, Hkv, S, T, D, causal, window = case
    jx, tx = _inputs((B, H, S, D), (B, Hkv, T, D), dtype, S + T + D)
    want = ref.attention_ref(*jx, causal=causal, window=window)
    got = pad_head_dim(flash_attention_ref, *tx, causal=causal,
                       window=window)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    assert got.is_contiguous()
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dtype])


def test_kernel_head_dims_and_declined_inputs():
    """The card's domain: every D ≤ 512 in float32, bfloat16 and float16,
    run at 64, 128, 256, 384 or 512 in 16 bits and at 64, 80, 128, 256,
    384 or 512 in float32; D outside 1..512 and other types (float64)
    raise ``ValueError`` naming the limit; float16 and D = 256, 320 and
    512 are taken."""
    assert MAX_HEAD_DIM == 512
    dims = (1, 8, 16, 63, 64, 65, 80, 81, 128, 129, 160, 200, 256, 257, 320,
            384, 385, 500, 512)
    wide = [256] * 4 + [384] * 3 + [512] * 3
    assert [kernel_head_dim(D) for D in dims] == [64] * 5 + [128] * 4 + wide
    for dt in (torch.bfloat16, torch.float16):
        assert [kernel_head_dim(D, dt) for D in dims] \
            == [64] * 5 + [128] * 4 + wide
    assert [kernel_head_dim(D, torch.float32) for D in dims] \
        == [64] * 5 + [80] * 2 + [128] * 2 + wide
    for D in (0, 513, 1024):
        with pytest.raises(ValueError, match="head dim .* 1..512"):
            kernel_head_dim(D)

    def qkv(D, dtype):
        return (torch.zeros((1, 2, 8, D), dtype=dtype),
                torch.zeros((1, 1, 8, D), dtype=dtype),
                torch.zeros((1, 1, 8, D), dtype=dtype))
    for D in (0, 513, 1024):
        with pytest.raises(ValueError, match="head dim"):
            check_kernel_inputs(*qkv(D, torch.float32))
    with pytest.raises(ValueError, match="float64"):
        check_kernel_inputs(*qkv(64, torch.float64))
    with pytest.raises(ValueError, match="head dim"):
        pad_head_dim(flash_attention_ref, *qkv(513, torch.float32))
    # taken: float16, and D up to 512 in every type (the shape and type
    # checks that need a CUDA tensor are the card's)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for D in (64, 200, 256, 320, 512):
            with pytest.raises(ValueError, match="CUDA"):
                check_kernel_inputs(*qkv(D, dt))


def _tf32(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: add half an ulp of TF32 to the magnitude bits and
    clear the 13 bits below it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, terms):
    """``einsum(eq, a, b)`` on the tensor cores' TF32 operands: with three
    terms lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), where hi = tf32(x) and
    lo = tf32(x - hi); with one, hi(a) hi(b).  A product of two TF32
    values is exact in float32, the sums are float32."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _flash_tf32(q, k, v, *, causal, window, terms=3):
    """The float32 kernel's algorithm on the CPU: KV tiles of 64 keys (D =
    64), 32 (D = 80, 128) or 16 (above 128), scores and P V as TF32 products
    (``_tf32_product``), the scale folded into an exp2, l the sum of the
    float32 p, masked scores at -1e30."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    block = 64 if D <= 64 else 32 if D <= 128 else 16
    c = torch.tensor(D ** -0.5 * math.log2(math.e), dtype=torch.float32)
    qf = q.reshape(B, Hkv, rep, S, D)
    m = torch.full((B, Hkv, rep, S, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, rep, S, D))
    qpos = torch.arange(S)[:, None] + (T - S)
    for j0 in range(0, T, block):
        kt, vt = k[:, :, j0:j0 + block], v[:, :, j0:j0 + block]
        s = _tf32_product("bkrsd,bktd->bkrst", qf, kt, terms) * c
        kpos = torch.arange(j0, j0 + kt.shape[2])[None, :]
        ok = torch.ones((S, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _tf32_product("bkrst,bktd->bkrsd", p, vt, terms)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).reshape(B, H, S, D)


def test_tf32_rounds_to_nearest_ties_away():
    """``_tf32`` keeps 10 mantissa bits, rounds halfway cases away from
    zero in both signs, and leaves TF32 values as they are."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + ulp,
                      -(1 + ulp / 2), 3.0 + 3 * ulp / 2], dtype=torch.float32)
    want = [1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.0 + 2 * ulp]
    assert _tf32(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                         .astype(np.float32))
    h = _tf32(y)
    assert torch.equal(_tf32(h), h)
    assert bool(((y - h).abs() <= h.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("case", PLAIN_CASES + [
    (1, 16, 16, 128, 128, 80, False, 0),
    (1, 2, 1, 128, 160, 512, True, 0),
    (1, 4, 2, 200, 200, 320, True, 64)], ids=lambda c: "-".join(
        str(x) for x in c))
def test_three_tf32_products_meet_the_f32_limit(case):
    """The float32 kernel's arithmetic (3xTF32 over its KV tiles, D = 80
    at its own width, D = 320 and 512 over tiles of 16) against JAX's dense reference in float32, within
    2e-5."""
    B, H, Hkv, S, T, D, causal, window = case
    jx, tx = _inputs((B, H, S, D), (B, Hkv, T, D), "float32", S + T + H)
    want = ref.attention_ref(*jx, causal=causal, window=window)
    got = _flash_tf32(*tx, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL["float32"])


def test_one_tf32_product_misses_the_f32_limit():
    """One TF32 product per operand pair, the rest as above, is off by
    more than the float32 atol on a seeded case: 3xTF32 is needed."""
    B, H, Hkv, S, T, D = 1, 2, 1, 256, 256, 128
    jx, tx = _inputs((B, H, S, D), (B, Hkv, T, D), "float32", 17)
    want = _f32(ref.attention_ref(*jx, causal=True))
    one = _f32(_flash_tf32(*tx, causal=True, window=0, terms=1))
    three = _f32(_flash_tf32(*tx, causal=True, window=0))
    assert np.abs(three - want).max() <= ATOL["float32"]
    assert np.abs(one - want).max() > 5 * ATOL["float32"]
