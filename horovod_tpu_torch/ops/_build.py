"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers,
so ``nvcc`` takes seconds, not minutes) and compiles into its own shared
library under ``ops/_build/``; the library's file name carries a hash of
its source and the header files, so an edited source is rebuilt and a
stale library is never loaded.  All sources compile at once, one
``nvcc`` process each, the first time any kernel is used.

Nothing here runs at import time: a machine without ``nvcc`` or a GPU
imports the package and uses the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C entry points: name -> (source, symbol, argtypes).  A source may
# export several entry points (``flash_bwd.cu``: dq and dk/dv;
# ``bn_bwd.cu``: the BatchNorm backward's two passes; ``fused_update.cu``:
# the three PowerSGD stages).  Every
# pointer and the stream are c_void_p (ctypes would cut a Python int to
# 32 bits).
ENTRIES = {
    "flash_fwd": ("flash_fwd", "hvd_flash_fwd", [
        _P, _P, _P,          # q, k, v
        _P, _P,              # q/kv segment ids (int32) or NULL
        _P, _P,              # o, lse
        _I, _I, _I, _I, _I, _I,   # b, h, h_kv, tq, tk, d
        _I, _I, _F,          # dtype (0 f32, 1 bf16), causal, scale
        _P]),                # stream
    "flash_decode": ("flash_decode", "hvd_flash_decode", [
        _P, _P, _P,          # q, k, v
        _P, _P,              # page_table (int32) or NULL, lengths (int32)
        _P, _P, _P, _P,      # o, m/l/acc partials (f32 scratch)
        _I, _I, _I, _I,      # slots, h, h_kv, d
        _I, _I,              # page_size, pages_per_slot
        _L, _L, _L,          # element strides: page, offset, head
        _I, _I,              # splits, keys per split
        _I, _F,              # dtype, scale
        _P]),                # stream
    "flash_bwd_dq": ("flash_bwd", "hvd_flash_bwd_dq", [
        _P, _P, _P, _P,      # q, k, v, dO
        _P, _P,              # lse, delta (f32)
        _P, _P,              # q/kv segment ids (int32) or NULL
        _P,                  # dq
        _I, _I, _I, _I, _I, _I,   # b, h, h_kv, tq, tk, d
        _I, _I, _F,          # dtype, causal, scale
        _P]),                # stream
    "flash_bwd_dkv": ("flash_bwd", "hvd_flash_bwd_dkv", [
        _P, _P, _P, _P,      # q, k, v, dO
        _P, _P,              # lse, delta (f32)
        _P, _P,              # q/kv segment ids (int32) or NULL
        _P, _P,              # dk, dv
        _I, _I, _I, _I, _I, _I,   # b, h, h_kv, tq, tk, d
        _I, _I, _F,          # dtype, causal, scale
        _P]),                # stream
    "bn_bwd_reduce": ("bn_bwd", "hvd_bn_bwd_reduce", [
        _P, _P,              # x, dy
        _P, _P,              # mean, inv (f32)
        _P, _P, _P,          # workspace, dbeta, dgamma (f32)
        _L, _I, _I,          # n, c, chunks
        _I, _I,              # vec (16-byte path), dtype
        _P]),                # stream
    "bn_bwd_dx": ("bn_bwd", "hvd_bn_bwd_dx", [
        _P, _P,              # x, dy
        _P, _P, _P,          # mean, inv, scale (f32)
        _P, _P,              # dbeta, dgamma (f32)
        _P,                  # dx
        _L, _I, _I,          # n, c, chunks
        _I, _I,              # vec, dtype
        _P]),                # stream
    "fused_update_matricize_p": ("fused_update", "hvd_fused_matricize_p", [
        _P, _P, _P,          # x (flat bucket), residual (f32) or NULL, q0
        _P, _P,              # acc [m, c], p [m, r] (f32)
        _L, _I, _I, _I,      # size, m, c, r
        _F, _I,              # prescale, dtype
        _P]),                # stream
    "fused_update_orthonormalize_q": (
        "fused_update", "hvd_fused_orthonormalize_q", [
            _P, _P,          # acc [m, c], mean p [m, r]
            _P, _P, _P,      # p_orth [m, r], workspace, q_local [c, r]
            _I, _I, _I, _I,  # m, c, r, chunks
            _P]),            # stream
    "fused_update_reconstruct": ("fused_update", "hvd_fused_reconstruct", [
        _P, _P, _P, _P,      # acc, p_orth, q (mean), q_local
        _P, _P,              # out, residual (flat, f32)
        _L, _I, _I, _I,      # size, m, c, r
        _F, _F,              # n_scale, postscale
        _P]),                # stream
}

# The sources, in the order they are first named above.
SOURCES = tuple(dict.fromkeys(src for src, _, _ in ENTRIES.values()))

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, else ``PATH``, else /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = [os.path.join(CSRC, f"{name}.cu")] + sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith(".cuh"))
    for path in paths:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_digest(name)}.so")


def nvcc_command(name: str, out: str) -> List[str]:
    """The command line that compiles ``csrc/<name>.cu`` into ``out``."""
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel;
    returns the seconds spent (about 0 when everything was built)."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for name in SOURCES:
            out = library_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            procs.append((name, out, tmp, subprocess.Popen(
                nvcc_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use),
    with ``argtypes``/``restype`` set on each of its entry points."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not os.path.exists(path):
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            for src, sym, argtypes in ENTRIES.values():
                if src == name:
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def entry(name: str):
    """The C entry point ``name`` of :data:`ENTRIES`."""
    src, sym, _ = ENTRIES[name]
    return getattr(library(src), sym)


def stream(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as the handle an
    entry point takes (a launch never synchronizes)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise if an entry point returned a CUDA error: a refused launch
    never runs, and no later synchronize reports it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
