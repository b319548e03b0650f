"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the sources in the package only, into
``kernels/build/`` (listed in ``.gitignore``); a library whose name
carries the hash of its source and of the ``csrc/`` headers it includes
is reused while none of them changes.
All sources build in parallel, one ``nvcc`` each.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` never reaches this code, because the kernel
wrappers take their plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

__all__ = ["load_library", "build_all", "total_builds"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# source file -> the C entry points it exports and their ctypes argtypes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = {
    # q k v ks vs pos bt mask o/m/l partials out, then (bf16, kv storage,
    # B, q_len, H, KV, D, max_len, bs, nb, n_split, split_keys, body, rows)
    "decode_attention.cu": {
        "paddle_flash_decode": [_P] * 12 + [_I] * 14 + [_F, _P],
    },
    # x w scale out part, then (bf16, fp8, M, N, K) and the launch plan
    # (body, tn, token_tiles, row_tiles, splits, per, stages, smem, items,
    # grid)
    "quant_matmul.cu": {
        "paddle_quant_matmul": [_P] * 5 + [_I] * 15 + [_P],
    },
    # x w scale shift ps pb out part1 part2, then (bf16, stats, relu, pre,
    # relu_in, N, H, W, C, K, ksize) and the launch plan (body, tile_rows,
    # tn, slab, a_rows, a_stages, w_stages, smem, tiles); the statistics:
    # part, then (tiles, K, count, span, scratch_rows), then scratch mean
    # var; the prologue's folded BatchNorm: mean var gamma beta,
    # (affine_bf16, C), eps, ps pb
    "fused_conv.cu": {
        "paddle_fused_conv": [_P] * 9 + [_I] * 20 + [_P],
        "paddle_conv_stats_finish": [_P] + [_I] * 5 + [_P] * 4,
        "paddle_bn_fold": [_P] * 4 + [_I] * 2 + [_F] + [_P] * 3,
    },
    # pointers, then an int64 stride array, then (bf16, B, S, H, D, causal)
    "flash_attention.cu": {
        "paddle_flash_fwd": [_P] * 7 + [_I] * 6 + [_F, _P],
        "paddle_flash_bwd_dkdv": [_P] * 10 + [_I] * 6 + [_F, _P],
        "paddle_flash_bwd_dq": [_P] * 9 + [_I] * 6 + [_F, _P],
    },
}

_lock = threading.Lock()
_libs: dict = {}
_builds = [0]   # nvcc runs of this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "toolkit is needed to build paddle_tpu_torch's kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_files(source: str) -> list:
    """``source`` and every header of ``csrc/`` it includes with quotes,
    directly or through another header, in the order first reached."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(_CSRC, name), "rb") as fh:
            todo += [m.decode() for m in _INCLUDE.findall(fh.read())]
    return seen


def _lib_path(source: str) -> str:
    """The library's path, named by a hash of the source and the headers
    it includes, so that an edited header builds anew."""
    h = hashlib.sha256()
    for name in _source_files(source):
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _start(source: str):
    """Start nvcc for ``source`` unless its library is already built;
    returns (output path, process or None)."""
    out = _lib_path(source)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    # -split-compile=0: nvcc runs its optimizer over the source's many
    # template instantiations on every core
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, os.path.join(_CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, (proc, tmp)


def _finish(source: str, out: str, started) -> None:
    if started is None:
        return
    proc, tmp = started
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source} (exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)
    _builds[0] += 1
    with open(out + ".ptxas.txt", "w") as fh:
        fh.write(err)


def build_all() -> dict:
    """Build every source not yet built (all nvcc processes started
    together) and load the libraries; returns {source: CDLL}."""
    with _lock:
        todo = [s for s in SOURCES if s not in _libs]
        started = {s: _start(s) for s in todo}
        errors = []
        for s, (out, st) in started.items():
            try:
                _finish(s, out, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for s, (out, _) in started.items():
            lib = ctypes.CDLL(out)
            for name, argtypes in SOURCES[s].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[s] = lib
        return dict(_libs)


def total_builds() -> int:
    """Libraries this process has built with nvcc (a library found
    already built on disk is loaded, not counted)."""
    return _builds[0]


def load_library(source: str):
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _libs.get(source)
    if lib is None:
        lib = build_all()[source]
    return lib
