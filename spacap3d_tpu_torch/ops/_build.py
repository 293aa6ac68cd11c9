"""Builds the CUDA kernels in ``csrc/`` and the host library
``csrc/spacap_host.cpp``, and loads them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (all sources at once,
one process each) and links one shared library with a plain C interface
into ``spacap3d_tpu_torch/_build/``, named by a hash of the sources and
flags so that an edited source rebuilds. ``g++`` compiles the host
library the same way (``host_build``; no ``nvcc`` needed, so it builds on
any machine with a C++ compiler). Nothing here runs at import time: the
first CUDA call to a kernel wrapper, or the first call to a host binding
(``data/native.py``), builds and loads its library, and a failed build
raises with the compiler's log.

Processes that start together (the ranks of a process group, the test
workers) build once: each build checks for its library and compiles it
under an exclusive ``fcntl.flock`` on a lock file in ``_build/``, so the
first builds and the others wait, then load the same file. Objects, logs
and the library are written under per-process names and renamed into
place, so a reader never sees half of one.
"""
from __future__ import annotations

import ctypes
import fcntl
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
HOST_SOURCE = CSRC / "spacap_host.cpp"
# no -march: the library is the same on every x86-64 host, and no
# multiply-add is contracted (the one that matters is an explicit std::fma)
HOST_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the host library cannot be built")
    return cxx


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
        log = open(BUILD_DIR / f"{src.stem}.{tag}.log", "w")
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
        logs = "\n".join((BUILD_DIR / f"{Path(f).stem}.{tag}.log").read_text()[-4000:]
                         for f in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    for src in sources:
        os.replace(BUILD_DIR / f"{src.stem}.{tag}.log", BUILD_DIR / f"{src.stem}.log")
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


def _locked_build(lib_path: Path, lock_name: str, compile_fn) -> Path:
    """``lib_path``, made by ``compile_fn(lib_path)`` first if it is missing:
    the check and the compile run under an exclusive lock, so one of
    several processes that start together builds and the others wait."""
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / lock_name, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib_path.exists():
                compile_fn(lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def build() -> Path:
    """The kernel library's path, built first if it is missing."""
    sources = _sources()
    return _locked_build(BUILD_DIR / f"libspacap_kernels-{_digest(sources)}.so",
                         "build.lock", lambda path: _compile(path, sources))


def _compile_host(lib_path: Path) -> None:
    tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
    res = subprocess.run([_cxx(), *HOST_FLAGS, str(HOST_SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {HOST_SOURCE.name}:\n"
                           f"{(res.stdout + res.stderr)[-4000:]}")
    os.replace(tmp, lib_path)


def host_build() -> Path:
    """The host library's path, built first if it is missing; named by a
    hash of its source and flags."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return _locked_build(BUILD_DIR / f"libspacap_host-{h.hexdigest()[:16]}.so",
                         "host.lock", _compile_host)


def library() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
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
    lib.spacap_ffn_partial.argtypes = [vp, vp, i32, i32, i32, i32, vp, vp]
    lib.spacap_ffn_partial.restype = i32
    lib.spacap_ffn_partial_launch_info.argtypes = [i32, i32, i32, i32p, i32p, i32p]
    lib.spacap_ffn_partial_launch_info.restype = i32
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
