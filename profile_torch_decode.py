"""Where the time goes in the decode kernel's e4m3 variant, on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 profile_torch_decode.py

At ``chip_smoke.py`` phase 3's shape (8 slots x 2048 live keys, Llama-3
8B heads, bf16, page 16) with none, every other or every full page
compressed, it prints one JSON line a case:

* ``ms``: the e4m3 kernel's device time (split + merge) from a replayed
  CUDA graph, and the uncompressed kernel's on the same pool;
* per-warp ``clock64`` stamps (median cycles over the live CTAs) of the
  split kernel's prologue (entry to the first tile's wait) and tile loop
  for warps 0-3, and of the whole CTA, from a copy of
  ``ops/csrc/flash_decode.cu`` built with stamps written at those points;
  ``cold`` over the pool as it is, ``hot`` with every table entry pointed
  into 16 pages (every copy an L2 hit): where a loop reads the same hot
  and cold, its warps wait on instructions, not on memory.

With every other page compressed, warps 0 and 2 take every e4m3 tile and
warps 1 and 3 every bf16 tile (tile t of a split is page t).  A GPU is
required; without one the script exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

# Where the stamps go: (anchor in flash_decode.cu, text put after it).
_STAMPS = (
    ("  constexpr int RB = row_bytes<T, D>();   // bytes of one key row\n",
     "  const long long c0 = clock64();\n"),
    ("  __syncthreads();  // q visible\n",
     "  const long long c1 = clock64();\n"),
    ("    __syncwarp();  // every lane is done with this stage and with sPw\n"
     "  }\n",
     "  const long long c2 = clock64();\n"),
    ("      l_part[row] = lsum;\n    }\n  }\n",
     "  if (lane == 0) {\n"
     "    long long* g = g_stamp + ((size_t)blockIdx.x * NW + warp) * 3;\n"
     "    g[0] = c1 - c0;\n    g[1] = c2 - c1;\n    g[2] = clock64() - c0;\n"
     "  }\n"),
)
_CTAS = 8192


def _stamped_library(build) -> ctypes.CDLL:
    """flash_decode.cu with the stamps, built beside the real library."""
    src = open(os.path.join(build.CSRC, "flash_decode.cu")).read()
    for anchor, text in _STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    src = src.replace("namespace {\n", "__device__ long long g_stamp[%d];\n"
                      "namespace {\n" % (_CTAS * 4 * 3), 1)
    src += ('extern "C" int stamp_read(long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_stamp, '
            'sizeof(g_stamp));\n}\n')
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "flash_decode_stamped.cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = os.path.join(build.BUILD_DIR, "libflash_decode_stamped.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
                    "-o", so, path], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for key in ("flash_decode", "flash_decode_fp8"):
        fn = getattr(lib, build.ENTRIES[key][1])
        fn.argtypes = build.ENTRIES[key][2]
        fn.restype = ctypes.c_int
    lib.stamp_read.argtypes = [ctypes.c_void_p]
    return lib


def _stamps(attn, build, lib, fn) -> dict:
    """Median prologue and loop cycles of warps 0-3 and of the CTA, over
    the live CTAs of one call of ``fn`` run through ``lib``."""
    real = attn.entry
    attn.entry = lambda name: getattr(lib, build.ENTRIES[name][1])
    try:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    finally:
        attn.entry = real
    buf = (ctypes.c_longlong * (_CTAS * 4 * 3))()
    if lib.stamp_read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the stamps failed")
    a = np.frombuffer(buf, dtype=np.int64).reshape(_CTAS, 4, 3)
    live = a[a[:, :, 2].max(1) > 0]
    med = lambda x: float(np.median(x))   # noqa: E731
    return {"ctas": int(len(live)), "cta": med(live[:, :, 2].max(1)),
            "prologue": [med(live[:, w, 0]) for w in range(4)],
            "loop": [med(live[:, w, 1]) for w in range(4)]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from horovod_tpu_torch.ops import _build as build
    from horovod_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    card = cs.card_line()
    build.build_all()
    lib = _stamped_library(build)
    for every in (0, 2, 1):
        q, kp, vp, read, lengths, fp8, _, _, table = cs.fp8_decode_case(
            dev, 16, 5, every)
        out = {"phase": "decode_fp8_profile", "card": card,
               "compressed_pages": int(fp8[5].sum()),
               "ms": cs.graph_ms(lambda: attn.paged_decode_attention_fp8(
                   q, kp, vp, read, lengths, *fp8)),
               "uncompressed_ms": cs.graph_ms(
                   lambda: attn.paged_decode_attention(
                       q, kp, vp, table, lengths))}
        hot = (torch.arange(table.numel(), device=dev) % 16).view(
            table.shape).to(torch.int32)
        for name, tab, ctab in (("cold", table, fp8[4]), ("hot", hot, hot)):
            rd = torch.where(fp8[5], read, tab)
            f8 = (*fp8[:4], ctab, fp8[5])
            out[name] = _stamps(attn, build, lib,
                                lambda: attn.paged_decode_attention_fp8(
                                    q, kp, vp, rd, lengths, *f8))
            out[name + "_uncompressed"] = _stamps(
                attn, build, lib, lambda: attn.paged_decode_attention(
                    q, kp, vp, tab, lengths))
        print(json.dumps(out), flush=True)
        del q, kp, vp, fp8
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
