"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (it may include the shared
``csrc/*.cuh`` bodies) and is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/repro_torch_kernels/`` at
the root of the checkout, then loaded with ``ctypes``.  Builds happen at
first use, all sources at once (one ``nvcc`` process each, started
together).  A library's file name carries a hash of its source, the
headers and the flags, so an edited source rebuilds and an unchanged one
loads the library already built.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "Built", "build_dir", "digest", "build_all", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gram", "qgram_packed", "epilogue", "epilogue_fleet", "quant_encode",
           "quant_decode", "qgram", "decode_attn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    """A loaded kernel library, the seconds its build took (0.0 when it was
    already built) and what ``ptxas -v`` reported (registers, shared
    memory and spills per kernel)."""

    name: str
    lib: ctypes.CDLL
    seconds: float
    ptxas: str


_BUILT: dict[str, Built] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path("/usr/local/cuda/bin/nvcc")
    if cuda.exists():
        return str(cuda)
    raise RuntimeError(
        "nvcc not found: the repro_torch kernels are built with the CUDA "
        "toolkit on the machine that has the card"
    )


@functools.lru_cache(maxsize=None)
def digest(name: str) -> str:
    """The hash of one library's source, the headers and the flags (read
    once a process): its file name carries it, and the autotune cache's
    keys name it."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared bodies they include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return build_dir() / f"lib{name}-{digest(name)}.so"


def build_all(names=SOURCES) -> dict[str, Built]:
    """Build (in parallel) and load every named kernel library not loaded
    yet; raise if any build fails.  Returns the loaded libraries."""
    with _LOCK:
        todo = [n for n in names if n not in _BUILT]
        if todo:
            build_dir().mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            started = time.perf_counter()
            for name in todo:
                out = _target(name)
                if out.exists():
                    _BUILT[name] = Built(name, ctypes.CDLL(str(out)), 0.0, "")
                    continue
                tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (tmp, out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            failed = []
            for name, (tmp, out, proc) in procs.items():
                log, _ = proc.communicate()
                seconds = time.perf_counter() - started
                if proc.returncode != 0:
                    failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
                    continue
                os.replace(tmp, out)
                _BUILT[name] = Built(name, ctypes.CDLL(str(out)), seconds, log)
            if failed:
                raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return {n: _BUILT[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    return build_all((name,))[name].lib
