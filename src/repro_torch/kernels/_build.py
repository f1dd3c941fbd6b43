"""Build ``csrc/*.cu`` with nvcc and bind the kernels with ctypes.

Each source becomes its own shared library with a plain C interface,
compiled for ``sm_90a`` at first use into ``build/repro_torch_kernels/``
under the repository root, in a directory keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  ``build_all`` starts one nvcc per source, all at once.  A failed
build raises; there is no fallback.

``-fmad=false`` keeps nvcc from fusing a multiply and an add: the
kernels' float results must equal their plain PyTorch versions bit for
bit, whatever the compiler would contract.  The sources in ``CONTRACTED``
are held to their plain versions at a stated tolerance instead, and are
built without it: the float32 flash attention's dot-product loops ran
1.29x faster fused on an H100 (PERF.md, section 6).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library", "error_string", "ptr",
           "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("walk_fused", "update_fused", "walk_sample", "radix_hist",
           "alias_build", "flash_attention", "flash_attention_sm90")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CONTRACTED = ("flash_attention", "flash_attention_sm90")

# Signatures of the C entry points: (argtypes, restype).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "walk_fused": {
        "walk_fused_launch": ([_P] * 10 + [_I] * 6 + [_F] + [_I] * 4 + [_P],
                              _I),
        "walk_segment_launch": ([_P] * 13 + [_I] * 6 + [_F] + [_I] * 4 + [_P],
                                _I),
        "walk_fused_occupancy": ([_I, _I], _I),
    },
    "update_fused": {
        "update_prep_lanes_launch": ([_P] * 10 + [_I] * 2 + [_F, _P], _I),
        "update_first_flags_launch": ([_P] * 2 + [_I] * 2 + [_P], _I),
        "update_prep_rows_launch": ([_P] * 16 + [_I] * 2 + [_P], _I),
        "update_fused_launch": ([_P] * 23 + [_I] * 9 + [_F, _F] + [_P], _I),
    },
    "walk_sample": {
        "walk_sample_launch": ([_P] * 10 + [_I] * 6 + [_P], _I),
        "walk_sample_uniform_launch": ([_P] * 6 + [_I] * 3 + [_P], _I),
        "walk_sample_occupancy": ([], _I),
    },
    "radix_hist": {"radix_hist_launch": ([_P] * 4 + [_I] * 3 + [_P], _I)},
    "alias_build": {"alias_build_launch": ([_P] * 3 + [_I] * 2 + [_P], _I)},
    "flash_attention": {
        "flash_attention_launch": ([_P] * 4 + [_I] * 8 + [_F, _P], _I),
    },
    "flash_attention_sm90": {
        "flash_attention_sm90_launch": ([_P] * 4 + [_I] * 9 + [_F, _P], _I),
    },
}

_LIBS: dict = {}
BUILD_LOG: dict = {}      # source name -> nvcc's output (ptxas register counts)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def _flags(name: str) -> list:
    if name in CONTRACTED:
        return [f for f in FLAGS if f != "-fmad=false"]
    return FLAGS


def _key(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_flags(name)).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_ROOT / _key(name) / f"lib{name}.so"


def build_all(names=SOURCES) -> float:
    """Compile every named source that is not built yet, one nvcc each,
    all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, restype
        err = lib.kernels_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def ptr(x) -> ctypes.c_void_p:
    """A tensor's device pointer for a C argument (NULL for None)."""
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def check(name: str, x, dtype, shape) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what a kernel's C interface takes."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous CUDA tensor")


def error_string(code: int, name: str | None = None) -> str:
    """The message of a code returned by a launch: ``cudaGetErrorString``,
    or the message of the library ``name`` for its own codes."""
    lib = _LIBS.get(name) or next(iter(_LIBS.values()), None)
    if lib is None:
        return str(code)
    return f"{code} ({lib.kernels_error_string(code).decode()})"
