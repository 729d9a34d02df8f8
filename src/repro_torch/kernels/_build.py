"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them by ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``_build/lib<name>_<hash>.so``; the hash covers the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header builds anew and an unchanged one is reused.
All missing libraries build at once, one ``nvcc`` each, on first use. Nothing
is built when the package is imported: the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found; the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source without a current library, all in parallel.

    Returns ``{stem: library path}``. The compiler's output (``-Xptxas -v``
    registers and spills) is kept beside each library as ``.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources():
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, proc, tmp, out))
    failed = []
    for src, proc, tmp, out in jobs:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {src.stem: library_path(src) for src in sources()}


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds on first use).

    Every source exports ``storm_cuda_error_string(int)`` beside its entry
    points, which return a ``cudaError_t`` code.
    """
    lib = ctypes.CDLL(str(build_all()[stem]))
    lib.storm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.storm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.storm_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
