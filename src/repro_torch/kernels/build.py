"""Build and load the port's CUDA kernels (nvcc into one shared library
with a plain C interface, loaded through ``ctypes``).

Every ``csrc/*.cu`` source is compiled on its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are then linked into
``<checkout>/build/repro_torch/libkernels.so``.  The build happens at first
use and again whenever a source or the flags change (a SHA-256 stamp beside
the library records what it was built from).  Nothing is built when a
module is imported: the CPU tests import every module on a host with no
``nvcc``.

``--use_fast_math`` is deliberately absent: it makes ``/`` and ``expf``
approximate, and the query and probability quantisers
(``rint(x / scale)``) would then flip codes against the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/src/repro_torch/kernels/build.py -> <checkout>/build/repro_torch
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"
# dynamic shared memory one H100 block may use (232,448 bytes)
MAX_SMEM = 232_448
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
# seconds from the start of the last build until each source's nvcc ended
COMPILE_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use on a CUDA host"
    )


def sources() -> List[pathlib.Path]:
    """The CUDA sources compiled into the library, in a stable order."""
    return sorted(CSRC.glob("*.cu"))


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the library if it is missing or stale; return its path.

    One ``nvcc -c`` per source runs in parallel, then one link; each
    source's seconds land in :data:`COMPILE_SECONDS`.  The
    library is written under a temporary name and renamed into place, so
    a build cut short never leaves a half-written library behind."""
    lib = BUILD_DIR / LIB_NAME
    stamp_file = BUILD_DIR / "libkernels.sha256"
    stamp = _stamp()
    if lib.exists() and stamp_file.exists() and stamp_file.read_text() == stamp:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs, t0 = [], [], time.perf_counter()
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            log = open(pathlib.Path(tmp) / (src.stem + ".log"), "w+")
            procs.append((src, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT,
            )))
        failed = []
        COMPILE_SECONDS.clear()
        pending = list(procs)
        while pending:  # poll, so each source's end is timed, not its turn in the list
            for src, log, p in [e for e in pending if e[2].poll() is not None]:
                pending.remove((src, log, p))
                COMPILE_SECONDS[src.name] = time.perf_counter() - t0
                log.seek(0)
                out = log.read()
                log.close()
                if verbose and out:
                    print(out, end="")
                if p.returncode:
                    failed.append(f"{src.name}:\n{out}")
            time.sleep(0.05)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = pathlib.Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    stamp_file.write_text(stamp)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    """Give every C entry point its argtypes: ``c_void_p`` for each pointer
    and the stream (a bare int would be cut to 32 bits), ``c_int`` /
    ``c_longlong`` for sizes and strides."""
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    U = ctypes.c_uint
    pfd_shape = [
        I, I, I, I, I, I,  # B, Hk, g, D, compiled width, pages_per_slot
        I, U, U,  # page size and its divider (magic, shift)
        I, I, I,  # plan: blocks a cluster, lanes a block, shared memory bytes
    ]
    lib.paged_flash_decode_dense_launch.argtypes = [
        P, P, P, P, P, P,  # q, k, v, page_ids, pos, out
        *pfd_shape,
        L, L, I, I, F, P,  # kv tok/head strides, wide rows, kv dtype code, scale, stream
    ]
    lib.paged_flash_decode_int8_launch.argtypes = [
        P, P, P, P, P, P, P, P,  # q, k, v, k_scale, v_scale, page_ids, pos, out
        *pfd_shape,
        L, L, L, L, I, F, P,  # kv strides, scale strides, wide rows, scale, stream
    ]
    lib.paged_flash_decode_pass_launch.argtypes = [
        P, P, P, P, P, P, P, P,  # q, k, v, k_scale, v_scale, page_ids, pos, out (scales: null)
        I, I, I, I, I, I,  # B, Hk, g, D, compiled width, pages_per_slot
        I, U, U,  # page size and its divider (magic, shift)
        I, I, I, I,  # plan: blocks a cluster, lanes a block, lanes a pass, shared memory
        L, L, L, L, I, I, F, P,  # kv / scale strides, wide rows, body, scale, stream
    ]
    lib.bgpp_paged_attend_launch.argtypes = [
        P, P, P, P, P, P, P, P, P, P,  # q, planes, sign, ks, v, vs, phys, pos, out, out_idx
        P,  # the lists' workspace (null: in shared memory)
        I, I, I, I, I, I,  # B, Hk, g, D, compiled width, S
        I, I, P, P,  # nbits, rounds, list widths and caps (host int arrays)
        I, I, I,  # plan: blocks a cluster, shared memory bytes; query_bits
        L, L, L,  # plane strides: plane, token, head (sign shares token/head)
        L, L, L, L,  # v token/head strides, scale token/head strides
        I, F, P,  # wide rows, scale, stream
    ]
    lib.bgpp_paged_attend_long_launch.argtypes = [
        P, P, P, P, P, P, P, P, P, P,  # q, planes, sign, ks, v, vs, phys, pos, out, out_idx
        P, L,  # the workspace and its ints
        I, I, I, I, I, I,  # B, Hk, g, D, compiled width, S
        I, I, P, I,  # nbits, rounds, list widths (host int array), query_bits
        L, L, L,  # plane strides: plane, token, head (sign shares token/head)
        L, L, L, L,  # v token/head strides, scale token/head strides
        I, F, P,  # wide rows, scale, stream
    ]
    lib.bstc_decode_launch.argtypes = [
        P, P, P, P,  # bitmap, tile_offsets, patterns, out
        I, I, I, I,  # G, H, tile_k, cap
        I, I, I, I, I, I, I, I, I,  # plan: R, WR, tps, NS, cap_s, copy; wide, blocks, smem
        P,  # stream
    ]
    lib.bstc_matmul_launch.argtypes = [
        P, P, P, I, L, L,  # plane table (host int64 array), sign, x, x dtype, x strides
        P, P, L, L,  # scale, out, out strides
        I, I, I, I, P, P,  # M, H, N, tile_k, plan (host int array), stream
    ]
    lib.flash_attention_launch.argtypes = [
        P, P, P, P, P,  # q, k, v, out, lse (null: not asked for)
        I, I, I, I, I, I, I, I,  # B, Sq, Sk, Hq, Hk, D, compiled width, wide rows
        L, L, L, L, L, L, L, L, L,  # q, k, v strides: batch, sequence, head
        I, I, I, I, F,  # dtype code, mask code, window, q_offset, scale
        I, I, P,  # plan: query rows a block, shared memory bytes; stream
    ]
    lib.flash_attention_bwd_launch.argtypes = [
        P, P, P, P, P, P, P,  # q, k, v, o, dout, lse, delta (workspace)
        P, P, P,  # dq, dk, dv
        I, I, I, I, I, I, I,  # B, Sq, Sk, Hq, Hk, D, compiled width
        L, L, L, L, L, L, L, L, L, L, L, L, L, L, L,  # q, k, v, o, dout strides: batch, seq, head
        I, I, I, I, F,  # dtype code, mask code, window, q_offset, scale
        I, I, I, P,  # plan: tile rows, dk/dv and dq shared memory bytes; stream
    ]
    lib.bgpp_score_launch.argtypes = [
        P, P, P, P, P,  # q, plane, sign, alive, out
        I, I, I, I, I,  # B, S, D, Hq, Hk
        I, I, I, I, I,  # plan: staged row words, lanes a key, keys a tile, shared memory; wide
        L, L, L, L, L, L, P,  # plane / sign strides: batch, token, head; stream
    ]
    lib.brcr_gemm_launch.argtypes = [
        P, P, P, I, L, L,  # group_idx, plane weights, x, x dtype, x strides
        P, L, L,  # out, out strides
        I, I, I, I, I, P, P,  # P planes, G, H, N, m, plan (host int array), stream
    ]
    for fn in (lib.paged_flash_decode_dense_launch,
               lib.paged_flash_decode_int8_launch,
               lib.paged_flash_decode_pass_launch,
               lib.bgpp_paged_attend_launch,
               lib.bgpp_paged_attend_long_launch,
               lib.bstc_decode_launch,
               lib.bstc_matmul_launch,
               lib.flash_attention_launch,
               lib.flash_attention_bwd_launch,
               lib.bgpp_score_launch,
               lib.brcr_gemm_launch):
        fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _LIB = lib
    return _LIB


def time_builds(trees: List[str]) -> None:
    """A clean build of each checkout's library in turn (its own
    ``build.py``, its ``build/repro_torch`` removed first), printing the
    seconds and when each source's ``nvcc`` ended: to compare two trees'
    builds on one host, e.g. ``python -m repro_torch.kernels.build PARENT .
    . PARENT``."""
    import importlib.util

    for i, tree in enumerate(trees):
        path = pathlib.Path(tree).resolve() / "src" / "repro_torch" / "kernels" / "build.py"
        spec = importlib.util.spec_from_file_location(f"_timed_build_{i}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        shutil.rmtree(mod.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        mod.build()
        ends = sorted(mod.COMPILE_SECONDS.items(), key=lambda kv: -kv[1])
        print(f"[build] {tree}: {time.perf_counter() - t0:.2f} s; each source's nvcc ended at: "
              + ", ".join(f"{n} {s:.1f} s" for n, s in ends), flush=True)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


if __name__ == "__main__":
    import sys

    time_builds(sys.argv[1:] or ["."])
