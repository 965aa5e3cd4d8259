"""Build the port's CUDA kernels from the repo's sources, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain ``extern "C"`` interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries land in ``build/kernels/`` at
the repository root (git-ignored), named by a hash of the source and flags,
so an edited source never loads a stale build.  :func:`build` compiles every
requested kernel in parallel (one ``nvcc`` per source, all started
together) and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only when a CUDA tensor reaches a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> loaded library / the compiler's -Xptxas -v report
_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS: Dict[str, str] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Compile (where needed) and load the named kernels' libraries."""
    names = list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for n in todo:
            lib = _target(n)
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
        failed = []
        for n, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            PTXAS[n] = log
            if proc.returncode != 0:
                failed.append(f"{n}:\n{log}")
                continue
            os.replace(tmp, lib)      # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for n in todo:
            _LIBS[n] = ctypes.CDLL(str(_target(n)))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it on first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build([name])[name]
