"""Build and bind the port's CUDA kernels.

Each kernel source under `csrc/` has plain C entry points. It is compiled
with nvcc for Hopper (`sm_90a`) into its own shared library under the
repo's `build/kernels/`, named by a hash of its source, the `csrc/`
headers it includes and the flags, at first use, and loaded with ctypes with every entry point's signature declared.
Nothing is built or loaded at import. `build_all` starts one nvcc per
source, all at once.

nvcc is found through CUDA_HOME, else /usr/local/cuda/bin/nvcc; without it
the build raises. A library's load is the set-up span `kernels.load`
(utils.tracing), and a build that runs nvcc `kernels.build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = {
    "fused_forward": _CSRC / "fused_forward.cu",
    "replay_vjp": _CSRC / "replay_vjp.cu",
    "cluster_cast": _CSRC / "cluster_cast.cu",
}
DEFAULT_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (entry point, argtypes) per library; every entry point returns a CUDA
# error code (0 on success)
SIGNATURES = {
    "fused_forward": {
        "cutrace_fused_forward": (
            [_P] * 9  # rays tri aabb plane sphere mat lights ambient out
            + [_I] * 11  # n_rays m c n_planes n_spheres n_lights n_mats
                         # bounces shadow_steps any_refl any_transp
            + [_F]  # fudge
            + [_P, _I, _I, _P]  # codes t_cnt p_cnt tally
            + [_P, _I, _I]  # tree leaves instance
            + [_P, _P]  # next_chunk stream
        ),
        "cutrace_shared_limit": [_P],  # bytes (int *)
        "cutrace_fused_forward_attributes": [_I, _P],  # instance out[4]
    },
    "replay_vjp": {
        "cutrace_replay_vjp": (
            [_P] * 9  # rays codes cot table lights ambient d_rays acc out
            + [_I] * 11  # n_rays n_pad k_rows n_tab t_cnt p_cnt n_lights
                         # bounces shadow_steps any_refl any_transp
            + [_F]  # fudge
            + [_I]  # smem_lo
            + [_P]  # stream
        ),
        # index values n n_el acc out stream
        "cutrace_exact_sum": [_P, _P, _I, _I, _P, _P, _P],
        "cutrace_replay_vjp_attributes": [_P],  # out[4]
    },
    "cluster_cast": {
        "cutrace_cluster_cast": (
            [_P] * 6  # rays tri aabb tree t_out ord_out
            + [_I] * 5  # n_rays m c leaves instance
            + [_P, _P]  # tally stream
        ),
        "cutrace_cluster_cast_attributes": [_I, _P],  # instance out[4]
    },
}
# Each library's resource query: (instance[, nodes], int out[4]) ->
# registers a thread, local memory bytes a thread, static shared bytes, max
# threads a block, as cudaFuncGetAttributes reports them for the
# instance's kernel.
ATTRIBUTES = {name: f"cutrace_{name}_attributes" for name in SIGNATURES}
ATTRIBUTE_NAMES = ("registers", "local_bytes", "static_shared_bytes",
                   "max_threads")

_libs: dict = {}


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(source: pathlib.Path) -> list:
    """The headers `source` includes with quotes, found beside it, and
    theirs in turn: each once, in the order first met."""
    seen, todo = [], [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            path = source.parent / name.decode()
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library built from `source` lives: keyed by a hash of the
    source, the headers it includes and the flags, so an edit of any of
    them builds anew."""
    h = hashlib.sha256(source.read_bytes())
    for header in included_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: pathlib.Path, verbose: bool):
    """Start nvcc on `source` unless its library exists: (target, tmp,
    cmd, process) or None."""
    target = library_path(source)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, cmd, proc


def _finish(job, verbose: bool):
    target, tmp, cmd, proc = job
    try:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
        if verbose:
            print(out)
        shutil.move(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(names=None, verbose: bool = False) -> dict:
    """Compile the named kernel libraries (all by default) that do not
    exist yet, one nvcc each, all started together; returns name -> library
    path. Raises with nvcc's output when a build fails."""
    from cutrace_tpu_torch.utils import tracing

    names = list(SOURCES) if names is None else list(names)
    jobs = [job for job in (_start(SOURCES[name], verbose) for name in names)
            if job is not None]
    try:
        if jobs:
            with tracing.setup_span("kernels.build"):
                for job in jobs:
                    _finish(job, verbose)
    finally:
        for job in jobs:
            if job[3].poll() is None:
                job[3].kill()
                job[3].wait()
    return {name: library_path(SOURCES[name]) for name in names}


def build(name: str = "fused_forward", verbose: bool = False) -> pathlib.Path:
    """Compile one kernel library unless it exists; returns its path."""
    return build_all([name], verbose)[name]


def load_library(name: str = "fused_forward") -> ctypes.CDLL:
    """A kernel library, built at first use, with its C entry points'
    signatures declared."""
    if name not in _libs:
        from cutrace_tpu_torch.utils import tracing

        with tracing.setup_span("kernels.load"):
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[name] = lib
    return _libs[name]


def kernel_attributes(name: str, *instance: int) -> dict:
    """The compiled resources of one instance of a kernel library's
    kernel (ATTRIBUTE_NAMES -> int): `instance` is the instance number
    (none for replay_vjp, which has one kernel). Raises on a CUDA
    error."""
    out = (ctypes.c_int * 4)()
    rc = getattr(load_library(name), ATTRIBUTES[name])(*instance, out)
    if rc != 0:
        raise RuntimeError(f"{name} attribute query failed: CUDA error {rc}")
    return dict(zip(ATTRIBUTE_NAMES, out))
