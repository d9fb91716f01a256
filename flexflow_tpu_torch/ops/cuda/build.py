"""Build the port's CUDA kernels with ``nvcc`` on first use, load with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface under ``build/kernels/`` at the repository root (listed in
``.gitignore``).  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build` starts one ``nvcc`` per missing library, all at once,
and waits for all of them.  Nothing here runs at import time: the CPU tests
import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "prefill_attention", "tree_attention")
# -Xptxas=-v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built on first use")
    return found


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES
          ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Build every library in ``names`` that is missing, one ``nvcc`` per
    source, all started together.  Returns ``({name: library path},
    {name: compiler output})``, the latter for the libraries compiled by
    this call (the ptxas report lands there)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths: Dict[str, str] = {}
    procs = {}
    for name in names:
        out = lib_path(name)
        paths[name] = str(out)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        logs[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[0][name])
            _LIBS[name] = lib
        return lib
