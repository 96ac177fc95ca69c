"""STL mesh import (binary + ASCII).

The reference imports models through Assimp (default_schema.hpp:516-545),
flattening every sub-mesh into one triangle list in file order. All four
bundled assets are *binary STL*, so a self-contained STL reader reproduces
the same triangle soup (Assimp's JoinIdenticalVertices only re-indexes,
it does not reorder faces or alter coordinates).

Missing/broken file semantics follow the reference: Assimp returning null
yields a silently *empty* mesh (default_schema.hpp:523) — we do the same but
emit a warning on stderr.

A native C++ fast path (native/cutrace_native.cpp) is used when built;
the numpy path below is the always-available fallback.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_BINARY_HEADER = 80
_TRI_RECORD = 50  # 12 floats (48 bytes) + uint16 attribute


def _parse_binary(data: bytes) -> np.ndarray:
    n = int(np.frombuffer(data, dtype="<u4", count=1, offset=_BINARY_HEADER)[0])
    body = np.frombuffer(
        data, dtype=np.uint8, count=n * _TRI_RECORD, offset=_BINARY_HEADER + 4
    ).reshape(n, _TRI_RECORD)
    floats = body[:, :48].copy().view("<f4").reshape(n, 4, 3)
    # record layout: facet normal, v1, v2, v3 — keep only the vertices
    return np.ascontiguousarray(floats[:, 1:4, :], dtype=np.float32)


def _parse_ascii(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, dtype=np.float32)
    if arr.size == 0:
        return np.zeros((0, 3, 3), np.float32)
    n = arr.shape[0] // 3
    return arr[: n * 3].reshape(n, 3, 3)


def load_stl(path: str) -> np.ndarray:
    """Load an STL file into an (N, 3, 3) float32 triangle-corner array.

    Returns an empty (0, 3, 3) array if the file is missing or malformed,
    matching the reference's silent-empty-mesh behavior. Prefers the
    native C++ parser (cutrace_tpu_torch.native) when built."""
    from cutrace_tpu_torch import native

    if native.available():
        try:
            tris = native.stl_parse(path)
            if tris is not None:
                return tris
        except OSError as e:
            print(
                f"warning: could not open mesh file '{path}': {e}",
                file=sys.stderr,
            )
            return np.zeros((0, 3, 3), np.float32)
        except ValueError:
            print(f"warning: mesh file '{path}' is malformed", file=sys.stderr)
            return np.zeros((0, 3, 3), np.float32)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"warning: could not open mesh file '{path}': {e}", file=sys.stderr)
        return np.zeros((0, 3, 3), np.float32)

    if len(data) < _BINARY_HEADER + 4:
        if data.lstrip().startswith(b"solid"):
            return _parse_ascii(data.decode("ascii", errors="replace"))
        print(f"warning: mesh file '{path}' is too short", file=sys.stderr)
        return np.zeros((0, 3, 3), np.float32)

    # A file is binary iff its size matches the header-declared count;
    # 'solid' prefixes exist in some binary files too, so size wins.
    n = int(np.frombuffer(data, dtype="<u4", count=1, offset=_BINARY_HEADER)[0])
    if len(data) >= _BINARY_HEADER + 4 + n * _TRI_RECORD and not (
        data.lstrip().startswith(b"solid") and b"facet" in data[:4096]
    ):
        return _parse_binary(data)
    if data.lstrip().startswith(b"solid"):
        return _parse_ascii(data.decode("ascii", errors="replace"))
    if len(data) >= _BINARY_HEADER + 4 + n * _TRI_RECORD:
        return _parse_binary(data)
    print(f"warning: mesh file '{path}' is malformed", file=sys.stderr)
    return np.zeros((0, 3, 3), np.float32)


def resolve_mesh_path(file_arg: str, scene_path: str | None) -> str:
    """Resolve a scene-relative mesh path.

    The reference resolves against the CWD only (schema.md uses paths like
    "scene/bunny.stl"). We keep that, then fall back to the scene file's
    directory, then to the bare basename next to the scene file, so scenes
    keep loading when invoked from any directory."""
    if os.path.isabs(file_arg) or os.path.exists(file_arg):
        return file_arg
    if scene_path:
        base = os.path.dirname(os.path.abspath(scene_path))
        for cand in (
            os.path.join(base, file_arg),
            os.path.join(base, os.path.basename(file_arg)),
        ):
            if os.path.exists(cand):
                return cand
    return file_arg
