"""Mesh import dispatch: STL (binary/ASCII), Wavefront OBJ, and PLY.

The reference imports meshes through Assimp, which accepts many formats
(default_schema.hpp:516-545) — though every bundled asset is binary STL.
For parity with users bringing their own models, OBJ and PLY (the other
ubiquitous triangle-soup formats) are supported natively here: vertices +
faces with fan triangulation of polygons, matching Assimp's
aiProcess_Triangulate flattening. Unknown extensions fall back to the STL
reader (which rejects gracefully into an empty mesh, the reference's
silent-empty behavior).
"""

from __future__ import annotations

import sys

import numpy as np

from cutrace_tpu_torch.scene.stl import load_stl


def load_obj(path: str) -> np.ndarray:
    """Wavefront OBJ -> (N, 3, 3) float32 triangle corners.

    Supports `v x y z` and `f i j k [l ...]` (1-based, negative indices
    relative to the end, `i/t/n` syntax); polygons are fan-triangulated in
    face order (Assimp's Triangulate behavior). Missing/broken files yield
    an empty mesh + stderr warning (reference semantics)."""
    try:
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()
    except OSError as e:
        print(f"warning: could not open mesh file '{path}': {e}",
              file=sys.stderr)
        return np.zeros((0, 3, 3), np.float32)

    verts = []
    tris = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v" and len(parts) >= 4:
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif parts[0] == "f" and len(parts) >= 4:
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):  # fan triangulation
                tris.append((idx[0], idx[k], idx[k + 1]))

    if not verts or not tris:
        print(f"warning: mesh file '{path}' has no triangles",
              file=sys.stderr)
        return np.zeros((0, 3, 3), np.float32)
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int64)
    if (t < 0).any() or (t >= len(v)).any():
        print(f"warning: mesh file '{path}' has out-of-range indices",
              file=sys.stderr)
        return np.zeros((0, 3, 3), np.float32)
    return v[t]


# numpy dtype per PLY scalar type name (both the classic and the
# sized spellings appear in the wild)
_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> np.ndarray:
    """PLY -> (N, 3, 3) float32 triangle corners.

    Handles ascii and binary_little/big_endian formats, arbitrary extra
    vertex properties (skipped), and face vertex lists of any length
    (fan-triangulated, like Assimp's Triangulate). Broken/missing files
    yield an empty mesh + stderr warning (the reference's silent-empty
    semantics for unloadable models, default_schema.hpp:523)."""
    warn = lambda msg: print(f"warning: mesh file '{path}': {msg}",
                             file=sys.stderr)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        warn(e)
        return np.zeros((0, 3, 3), np.float32)
    try:
        end = data.index(b"end_header\n") + len(b"end_header\n")
    except ValueError:
        warn("no PLY end_header")
        return np.zeros((0, 3, 3), np.float32)
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype | (count_t, item_t))])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and len(parts) >= 3:
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append((parts[4], (parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1]))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        warn(f"unsupported PLY format {fmt!r}")
        return np.zeros((0, 3, 3), np.float32)
    bo = "<" if fmt != "binary_big_endian" else ">"

    verts, faces = [], []
    try:
        if fmt == "ascii":
            toks = body.decode("ascii", errors="replace").split()
            pos = [0]

            def take(n):
                t = toks[pos[0]:pos[0] + n]
                pos[0] += n
                return t

            for name, count, props in elements:
                for _ in range(count):
                    row = {}
                    for pname, ptype in props:
                        if isinstance(ptype, tuple):
                            k = int(take(1)[0])
                            row[pname] = [float(x) for x in take(k)]
                        else:
                            row[pname] = float(take(1)[0])
                    if name == "vertex":
                        verts.append((row["x"], row["y"], row["z"]))
                    elif name == "face":
                        key = ("vertex_indices"
                               if "vertex_indices" in row else "vertex_index")
                        faces.append([int(i) for i in row[key]])
        else:
            off = [0]

            def scal(t):
                dt = np.dtype(bo + _PLY_TYPES[t])
                v = np.frombuffer(body, dt, 1, off[0])[0]
                off[0] += dt.itemsize
                return v

            for name, count, props in elements:
                fixed = all(not isinstance(p[1], tuple) for p in props)
                if fixed and name == "vertex":
                    # bulk path: one structured read for all vertices
                    dt = np.dtype([(p, bo + _PLY_TYPES[t])
                                   for p, t in props])
                    arr = np.frombuffer(body, dt, count, off[0])
                    off[0] += dt.itemsize * count
                    verts = np.stack(
                        [arr["x"], arr["y"], arr["z"]], axis=1
                    ).astype(np.float32)
                    continue
                for _ in range(count):
                    row = {}
                    for pname, ptype in props:
                        if isinstance(ptype, tuple):
                            k = int(scal(ptype[0]))
                            dt = np.dtype(bo + _PLY_TYPES[ptype[1]])
                            row[pname] = np.frombuffer(body, dt, k, off[0])
                            off[0] += dt.itemsize * k
                        else:
                            row[pname] = scal(ptype)
                    if name == "vertex":
                        verts.append((row["x"], row["y"], row["z"]))
                    elif name == "face":
                        key = ("vertex_indices"
                               if "vertex_indices" in row else "vertex_index")
                        faces.append([int(i) for i in row[key]])
    except (IndexError, ValueError, KeyError) as e:
        warn(f"malformed PLY body ({e})")
        return np.zeros((0, 3, 3), np.float32)

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    tris = []
    for face in faces:
        for k in range(1, len(face) - 1):  # fan triangulation
            tris.append((face[0], face[k], face[k + 1]))
    if len(v) == 0 or not tris:
        warn("no triangles")
        return np.zeros((0, 3, 3), np.float32)
    t = np.asarray(tris, np.int64)
    if (t < 0).any() or (t >= len(v)).any():
        warn("out-of-range indices")
        return np.zeros((0, 3, 3), np.float32)
    return v[t]


def load_mesh(path: str) -> np.ndarray:
    """Load a mesh by extension: .obj / .ply via their readers, everything
    else via the STL reader."""
    low = str(path).lower()
    if low.endswith(".obj"):
        return load_obj(path)
    if low.endswith(".ply"):
        return load_ply(path)
    return load_stl(path)


def subdivide(vertices: np.ndarray, levels: int = 1) -> np.ndarray:
    """Midpoint 1:4 subdivision of a triangle soup (N, 3, 3) -> (4^L*N, 3, 3).

    Splits every triangle at its edge midpoints; the union of the four
    children is exactly the parent's surface, so renders of a subdivided
    mesh match the original (up to tie-breaks on shared edges). Used to
    scale scenes to arbitrary triangle counts (the reference loads
    arbitrary-size models through Assimp, default_schema.hpp:516-545)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3, 3)
    for _ in range(levels):
        p1, p2, p3 = v[:, 0], v[:, 1], v[:, 2]
        m12 = 0.5 * (p1 + p2)
        m23 = 0.5 * (p2 + p3)
        m31 = 0.5 * (p3 + p1)
        v = np.concatenate([
            np.stack([p1, m12, m31], axis=1),
            np.stack([m12, p2, m23], axis=1),
            np.stack([m31, m23, p3], axis=1),
            np.stack([m12, m23, m31], axis=1),
        ])
    return v
