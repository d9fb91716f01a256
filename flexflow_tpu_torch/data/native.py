"""ctypes binding for the native batch-staging engine.

Port of ``flexflow_tpu/data/native.py``: the engine is a copy of the
reference's ``native/dataloader.cc`` (``flexflow_tpu_torch/native/``),
so it draws the reference engine's order for a seed.  It is built with
``g++`` into ``build/native/`` at the repository root (listed in
``.gitignore``) at first use, never into the source tree, under a file
name that carries a hash of the source and the flags (an edited source
is rebuilt, a stale library never loaded), and loaded with ctypes, as
``ops/cuda/build.py`` builds the kernels.  A build that fails raises;
nothing falls back to the Python path (the reference does,
``flexflow_tpu/data/native.py:31-47``).  ``CXX`` names the compiler
(default the ``CXX`` environment variable, else ``g++``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libffdl-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The engine's library, compiled by ``CXX`` if it is missing;
    raises ``RuntimeError`` when the compiler fails or is absent."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"native dataloader: {' '.join(cmd)} could "
                           f"not run: {err}") from err
    if res.returncode != 0:
        raise RuntimeError(f"native dataloader: {CXX} exited "
                           f"{res.returncode}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded engine, built at the first call."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.ffdl_create.restype = ctypes.c_void_p
        lib.ffdl_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ]
        lib.ffdl_batches_per_epoch.restype = ctypes.c_int64
        lib.ffdl_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.ffdl_next.restype = ctypes.c_int64
        lib.ffdl_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.ffdl_destroy.restype = None
        lib.ffdl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeBatcher:
    """Background-threaded shuffled batch gather over one (x, y) pair.

    Rows are copied by the C++ worker without the GIL; each ``next()``
    returns numpy views over the engine's staging buffer (valid until the
    following ``next()``), which the caller copies at once.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2):
        lib = load()
        self._lib = lib
        # contiguous copies alive for the engine's lifetime
        self._x = np.ascontiguousarray(x)
        self._y = np.ascontiguousarray(y)
        self.batch = int(batch)
        self.x_shape = (self.batch,) + self._x.shape[1:]
        self.y_shape = (self.batch,) + self._y.shape[1:]
        row_bytes = self._x.dtype.itemsize * int(
            np.prod(self._x.shape[1:], dtype=np.int64) or 1)
        label_bytes = self._y.dtype.itemsize * int(
            np.prod(self._y.shape[1:], dtype=np.int64) or 1)
        self.pos = 0  # batches consumed (the DataLoader's epoch count)
        self._h = lib.ffdl_create(
            self._x.ctypes.data_as(ctypes.c_void_p),
            self._y.ctypes.data_as(ctypes.c_void_p),
            len(self._x), row_bytes, label_bytes, self.batch,
            int(prefetch), int(bool(shuffle)), int(seed) & (2**64 - 1),
        )
        if not self._h:
            raise ValueError("bad dataloader arguments")

    @property
    def batches_per_epoch(self) -> int:
        return int(self._lib.ffdl_batches_per_epoch(self._h))

    def next(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """(x_batch, y_batch, epoch): views into the staging buffer."""
        px, py = ctypes.c_void_p(), ctypes.c_void_p()
        epoch = self._lib.ffdl_next(
            self._h, ctypes.byref(px), ctypes.byref(py))
        xb = np.ctypeslib.as_array(
            ctypes.cast(px, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(np.prod(self.x_shape)) * self._x.dtype.itemsize,),
        ).view(self._x.dtype).reshape(self.x_shape)
        yb = np.ctypeslib.as_array(
            ctypes.cast(py, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(np.prod(self.y_shape)) * self._y.dtype.itemsize,),
        ).view(self._y.dtype).reshape(self.y_shape)
        return xb, yb, int(epoch)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ffdl_destroy(self._h)
            self._h = None

    def __del__(self):  # the engine's thread ends with its loader
        try:
            self.close()
        except Exception:
            pass
