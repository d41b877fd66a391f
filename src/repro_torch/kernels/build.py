"""Build the CUDA kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (pointers as ``void*``,
the stream last) and compiles on its own into
``kernels/build/lib<name>-<hash>.so``; the hash covers the source, every
shared header ``csrc/*.cuh`` and the flags, so an edited kernel or header
rebuilds and a stale library is never loaded.
``build()`` starts one ``nvcc`` per missing library, all at once, and
waits for them together.  There is no fallback: a missing ``nvcc`` or a
failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
SOURCES = ("fier_retrieve", "fier_attend", "fier_score", "fier_topk", "fier_pack")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on the GPU machine")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, tuple[float, str]]:
    """Compile every library in ``names`` that is not built yet, with all
    ``nvcc`` processes running at once.  Returns, per library built, the
    seconds it took and nvcc's register/shared-memory report."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, out)
    built, errors = {}, []
    for n, (p, tmp, out) in procs.items():
        _, stderr = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{stderr}")
            continue
        built[n] = (time.perf_counter() - t0, stderr.strip())
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
