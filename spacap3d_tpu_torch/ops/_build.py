"""Builds the CUDA kernels in ``csrc/`` and loads them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (all sources at once,
one process each) and links one shared library with a plain C interface
into ``spacap3d_tpu_torch/_build/``, named by a hash of the sources and
flags so that an edited source rebuilds. Nothing here runs at import time:
the first CUDA call to a kernel wrapper builds and loads the library, and
a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    """Of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(lib_path: Path, sources) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        log = open(BUILD_DIR / f"{src.stem}.log", "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
        objs.append(obj)
    failed = []
    for src, log, proc in procs:
        if proc.wait() != 0:
            failed.append(src.name)
        log.close()
    if failed:
        logs = "\n".join((BUILD_DIR / f"{Path(f).stem}.log").read_text()[-4000:]
                         for f in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
    subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)], check=True)
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()


def ptxas_info() -> dict:
    """Per kernel entry (mangled name), as ``nvcc -Xptxas -v`` printed it at
    the last build: registers, stack frame, spill stores and loads (bytes),
    static shared memory (bytes) and, where ptxas serialized its wgmma or
    injected a wait for its accumulators (notes C7510-C7519), the notes'
    codes."""
    info, entry = {}, None
    for src in _sources():
        log = BUILD_DIR / f"{src.stem}.log"
        if not log.exists():
            continue
        for ln in log.read_text().splitlines():
            m = re.search(r"\((C751\d)\) .*(?:wgmma|GMMA).* in (?:the )?function '([^']+)'", ln)
            if m:
                notes = info.setdefault(m.group(2), {}).setdefault("wgmma_serialized", [])
                if m.group(1) not in notes:
                    notes.append(m.group(1))
                continue
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = info.setdefault(m.group(1), {})
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            if m:
                entry.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                entry["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                entry["static_smem"] = int(m.group(1)) if m else 0
    return info


def library() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = _sources()
    lib_path = BUILD_DIR / f"libspacap_kernels-{_digest(sources)}.so"
    if not lib_path.exists():
        _compile(lib_path, sources)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    i32p = ctypes.POINTER(i32)
    lib.spacap_fps.argtypes = [vp, i32, i32, i32, i32, i32, vp, vp, vp]
    lib.spacap_fps.restype = i32
    lib.spacap_fps_block_points.argtypes = []
    lib.spacap_fps_block_points.restype = i32
    lib.spacap_fps_launch_info.argtypes = [i32, i32, i32, i32p, i32p, i32p, i32p]
    lib.spacap_fps_launch_info.restype = i32
    lib.spacap_ball_query.argtypes = [vp, vp, i32, i32, i32, ctypes.c_float, i32, i32, vp, vp]
    lib.spacap_ball_query.restype = i32
    lib.spacap_ball_query_tile_points.argtypes = []
    lib.spacap_ball_query_tile_points.restype = i32
    lib.spacap_ball_query_warps.argtypes = []
    lib.spacap_ball_query_warps.restype = i32
    lib.spacap_ball_query_launch_info.argtypes = [i32, i32p, i32p, i32p]
    lib.spacap_ball_query_launch_info.restype = i32
    lib.spacap_generator_argmax.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp, vp]
    lib.spacap_generator_argmax.restype = i32
    lib.spacap_generator_launch_info.argtypes = [i32, i32, i32, i32, i32p, i32p, i32p]
    lib.spacap_generator_launch_info.restype = i32
    lib.spacap_ffn.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, vp]
    lib.spacap_ffn.restype = i32
    lib.spacap_ffn_launch_info.argtypes = [i32, i32, i32, i32p, i32p, i32p]
    lib.spacap_ffn_launch_info.restype = i32
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
