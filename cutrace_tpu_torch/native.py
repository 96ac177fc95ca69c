"""ctypes bindings for the native runtime (the port's copy of
cutrace_tpu.native).

The host-side runtime pieces the reference implements natively (Assimp
mesh import, stb JPEG encode) and the median-split cluster partition have C++
sources in the repo's `native/`. This module compiles them with g++ into a
library under the repo's gitignored `build/native/`, named by a hash of the
sources and flags, at first use, and loads it with ctypes. It never loads
the library the JAX package builds. Every entry point has a pure Python
fallback, so the port works where no compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
SOURCES = ("stl.cpp", "jpeg.cpp", "cluster.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> pathlib.Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libcutrace_native-{h.hexdigest()[:16]}.so"


def ensure_built() -> Optional[pathlib.Path]:
    """Build the library with g++ unless it exists; returns its path, or
    None when the sources or a compiler are missing or the build fails."""
    try:
        target = library_path()
    except OSError:
        return None
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp,
             *(str(_NATIVE_DIR / name) for name in SOURCES)],
            capture_output=True,
        )
        if proc.returncode != 0:
            return None
        shutil.move(tmp, target)
    except OSError:
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None when unavailable (fallbacks apply)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = ensure_built()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        lib.cutrace_stl_parse.restype = ctypes.POINTER(ctypes.c_float)
        lib.cutrace_stl_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.cutrace_free.argtypes = [ctypes.c_void_p]
        lib.cutrace_jpeg_write.restype = ctypes.c_int
        lib.cutrace_jpeg_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.cutrace_build_clusters.restype = ctypes.c_int64
        lib.cutrace_build_clusters.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def stl_parse(path: str) -> Optional[np.ndarray]:
    """Parse an STL file natively -> (N, 3, 3) float32 triangles, or None
    if the native library is unavailable. Raises on unreadable/malformed
    files (matching scene/stl.py error semantics)."""
    lib = load()
    if lib is None:
        return None
    count = ctypes.c_int64(0)
    ptr = lib.cutrace_stl_parse(str(path).encode(), ctypes.byref(count))
    if not ptr:
        if count.value == -1:
            raise OSError(f"cannot read STL file '{path}'")
        raise ValueError(f"malformed STL file '{path}'")
    try:
        n = count.value
        arr = np.ctypeslib.as_array(ptr, shape=(n * 9,)).copy()
    finally:
        lib.cutrace_free(ptr)
    return arr.reshape(n, 3, 3)


def jpeg_write(path: str, rgb: np.ndarray, quality: int = 90) -> bool:
    """Write an (H, W, 3) uint8 image as baseline JPEG natively. Returns
    False when the native library is unavailable (caller falls back)."""
    lib = load()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    assert c == 3
    rc = lib.cutrace_jpeg_write(
        str(path).encode(),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w,
        h,
        quality,
    )
    if rc != 0:
        raise OSError(f"JPEG encode failed ({rc}) for '{path}'")
    return True


def build_clusters(centroids: np.ndarray, cluster_size: int):
    """Native median-split. Returns (perm, starts, counts) int64 arrays or
    None when unavailable."""
    lib = load()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, dtype=np.float32)
    n = c.shape[0]
    perm = np.zeros(n, np.int64)
    cap = max(2 * n // max(cluster_size, 1) + 2, 4)
    starts = np.zeros(cap, np.int64)
    counts = np.zeros(cap, np.int64)
    leaves = lib.cutrace_build_clusters(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        cluster_size,
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if leaves < 0:
        raise ValueError("native cluster build failed")
    return perm, starts[:leaves], counts[:leaves]
