"""Build and bind the port's CUDA kernels.

Each kernel source under `csrc/` has a plain C entry point. It is compiled
with nvcc for Hopper (`sm_90a`) into a shared library under the repo's
`build/kernels/`, named by a hash of its source and flags, at first use,
and loaded with ctypes. Nothing is built or loaded at import.

nvcc is found through CUDA_HOME, else /usr/local/cuda/bin/nvcc; without it
the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SOURCE = _CSRC / "fused_forward.cu"
DEFAULT_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")

_lib = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = ([pathlib.Path(cuda_home) / "bin" / "nvcc"] if cuda_home
                  else []) + [DEFAULT_NVCC]
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built")


def library_path(source: pathlib.Path = SOURCE) -> pathlib.Path:
    """Where the library built from `source` lives: keyed by a hash of the
    source and the flags, so an edit builds anew."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: pathlib.Path = SOURCE, verbose: bool = False) -> pathlib.Path:
    """Compile `source` unless its library exists; returns the library
    path. Raises with nvcc's output when the build fails."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        shutil.move(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_library() -> ctypes.CDLL:
    """The fused-forward library, built at first use, with its C entry
    point's signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.cutrace_fused_forward
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 9  # rays tri aabb plane sphere mat lights
                                   # ambient out
            + [ctypes.c_int] * 11  # n_rays m c n_planes n_spheres n_lights
                                   # n_mats bounces shadow_steps any_refl
                                   # any_transp
            + [ctypes.c_float, ctypes.c_void_p]  # fudge, stream
        )
        _lib = lib
    return _lib
