"""Build and bind the package's CUDA C++ kernels, and import Triton.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own with ``nvcc`` for ``sm_90a`` into ``_build/lib<name>.so`` (a directory
git ignores), then loaded with ``ctypes``. Pointers and the CUDA stream pass
as ``c_void_p``; every C entry returns ``cudaGetLastError()`` after its
launch, and ``check`` raises on a non-zero code. Only the sources in this
package are built. A library is rebuilt when its source, or any header
``csrc/*.cuh`` (which every source may include), is newer than it.

``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them; the first kernel call builds its own library if it is missing.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

#: ptxas resource lines (registers, shared memory, spills) of each build
build_log: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, out = _paths(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return out.stat().st_mtime < newest


def _start(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu``; it writes a temporary file
    that ``_finish`` moves into place, so a library is never half-written."""
    src, out = _paths(name)
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out


def _finish(job):
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_log[name] = log


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every stale source in parallel; returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = [_start(n) for n in sources() if _stale(n)]
    for job in jobs:
        _finish(job)
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built first if stale.
    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns an ``int`` CUDA error code."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            _finish(_start(name))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")


def triton():
    """Import Triton with its cache inside the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    import triton as _triton  # noqa: PLC0415 - absent where no card is

    return _triton
