#!/usr/bin/env python3
"""B7 (``csrc/flash_attention.cu``) built with and without ``-fmad=false``,
timed in one process on one card.

    python3 tools/flash_fmad_ab.py

Builds the source twice from ``_build.FLAGS``, once with ``-fmad=false``
("exact") and once without it ("contracted": nvcc may fuse a multiply and
an add), into a temporary directory.  Then, on the inputs of
``chip_smoke.py``'s phase 3e (Mixtral 8x7B's attention, 32/8 heads,
D = 128, S = T = 32,768, bf16; the 4096 window and full causal), it
times each build in the order exact, contracted, contracted, exact, each
a median of 3 CUDA-event runs, and holds every output against
``flash_attention_ref`` at ``FLASH_TOL``.  Prints ptxas's register lines,
the card's name and power limit, and one JSON line of the times.
"""

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (ATTN_DIM, ATTN_HEADS, ATTN_KV_HEADS,  # noqa: E402
                        ATTN_SEQ, ATTN_WINDOW, card_line, cuda_ms,
                        flash_excess)


def build(flags, out):
    """nvcc ``csrc/flash_attention.cu`` with ``flags`` into ``out``; returns
    the loaded library and ptxas's register lines."""
    from repro_torch.kernels import _build
    log = subprocess.run(
        [_build._nvcc(), *flags, "-o", str(out),
         str(_build.CSRC / "flash_attention.cu")],
        capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in _build._SIGNATURES["flash_attention"].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, restype
    err = lib.kernels_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    regs = [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
            if "registers" in ln]
    return lib, regs


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_fmad_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention_ref
    exact = list(_build.FLAGS)                  # holds -fmad=false
    contracted = [f for f in exact if f != "-fmad=false"]
    tmp = Path(tempfile.mkdtemp(prefix="flash_fmad_ab_"))
    try:
        libs = {}
        for name, flags in (("exact", exact), ("contracted", contracted)):
            libs[name], regs = build(flags, tmp / f"lib{name}.so")
            print(f"{name}: {'; '.join(regs)}", flush=True)
        H, Hkv, D, S = ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM, ATTN_SEQ
        g = torch.Generator(device="cuda").manual_seed(11)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16) for shape in
                   ((1, H, S, D), (1, Hkv, S, D), (1, Hkv, S, D)))
        times = {}
        for case, w in (("window", ATTN_WINDOW), ("causal", 0)):
            want = flash_attention_ref(q, k, v, causal=True, window=w)
            for name in ("exact", "contracted", "contracted", "exact"):
                _build._LIBS["flash_attention"] = libs[name]
                ms, got = cuda_ms(lambda: ops.flash_attention(
                    q, k, v, causal=True, window=w))
                excess = flash_excess(got, want, "bfloat16")
                if excess > 1:
                    raise RuntimeError(f"{name} {case}: {excess:.3f} of the "
                                       "limit")
                times.setdefault(f"{case}_{name}_ms", []).append(ms)
            del want
        print(card_line(), flush=True)
        print(json.dumps(times), flush=True)
        return 0
    finally:
        _build._LIBS.pop("flash_attention", None)
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
