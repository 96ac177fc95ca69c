"""The reference's own scene loader: a frozen copy of the scene schema's
semantics (the upstream cutrace's loader.hpp and default_schema.hpp) for
the kinds the benchmark's scenes use.

Objects keep their file order, which is the nearest-hit scan order:
"triangle" (p1, p2, p3), "mesh" / "model" (a binary or ASCII STL file),
"plane" (point, normal), "sphere" (center, radius). Lights: "sun"
(direction, color) and "point" / "position" (point, color). Materials:
"solid" (color; specular 0.3, reflect 0, phong 32, transparency 0 by
default; a type-less material is solid). Camera: eye, up, look, width,
height, ambient. Every number is read as float32, as authored scenes are.
A mesh file is found as given, then beside the scene file, then by its
base name beside the scene file.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

_HEADER = 80
_RECORD = 50


def _vec(x):
    return np.asarray(x, np.float32).reshape(3)


@dataclasses.dataclass
class SceneData:
    """A scene as float32 numpy arrays, each primitive with the index of
    its object in the file (a mesh is one object of many triangles)."""

    tris: np.ndarray  # (T, 3, 3) corners p1, p2, p3
    tri_obj: np.ndarray  # (T,) object index
    tri_mat: np.ndarray  # (T,)
    tri_mesh: np.ndarray  # (T,) bool: the triangle belongs to a mesh
    pl_point: np.ndarray  # (P, 3)
    pl_normal: np.ndarray  # (P, 3)
    pl_obj: np.ndarray
    pl_mat: np.ndarray
    sp_center: np.ndarray  # (S, 3)
    sp_radius: np.ndarray  # (S,)
    sp_obj: np.ndarray
    sp_mat: np.ndarray
    mat_color: np.ndarray  # (K, 3)
    mat_specular: np.ndarray
    mat_reflect: np.ndarray
    mat_phong: np.ndarray
    mat_transparency: np.ndarray
    light_point: np.ndarray  # (L, 3): a point light's position, a sun's direction
    light_sun: np.ndarray  # (L,) bool
    light_color: np.ndarray  # (L, 3)
    eye: np.ndarray
    look: np.ndarray
    up: np.ndarray
    width: int
    height: int
    ambient: float
    n_objects: int


def read_stl(path: str) -> np.ndarray:
    """(N, 3, 3) float32 triangle corners of a binary or ASCII STL file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) >= _HEADER + 4:
        n = int(np.frombuffer(data, "<u4", 1, _HEADER)[0])
        ascii_ = data.lstrip().startswith(b"solid") and b"facet" in data[:4096]
        if len(data) >= _HEADER + 4 + n * _RECORD and not ascii_:
            body = np.frombuffer(data, np.uint8, n * _RECORD, _HEADER + 4)
            floats = body.reshape(n, _RECORD)[:, :48].copy().view("<f4")
            return floats.reshape(n, 4, 3)[:, 1:4].astype(np.float32)
    verts = [[float(v) for v in line.split()[1:4]]
             for line in data.decode("ascii", "replace").splitlines()
             if line.split()[:1] == ["vertex"]]
    arr = np.asarray(verts, np.float32).reshape(-1, 3)
    return arr[: arr.shape[0] // 3 * 3].reshape(-1, 3, 3)


def _mesh_path(name: str, scene_path: str) -> str:
    if os.path.isabs(name) or os.path.exists(name):
        return name
    base = os.path.dirname(os.path.abspath(scene_path))
    for cand in (os.path.join(base, name),
                 os.path.join(base, os.path.basename(name))):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"mesh file {name!r} of {scene_path}")


def load(path: str) -> SceneData:
    """Read a scene file."""
    with open(path) as f:
        raw = json.load(f)
    tris, tri_obj, tri_mat, tri_mesh = [], [], [], []
    planes, spheres = [], []
    for i, ob in enumerate(raw["objects"]):
        kind, mat = ob["type"], int(ob["material"])
        if kind == "triangle":
            tris.append(np.stack([_vec(ob[k]) for k in ("p1", "p2", "p3")])[None])
            tri_obj.append([i])
            tri_mat.append([mat])
            tri_mesh.append([False])
        elif kind in ("mesh", "model"):
            v = read_stl(_mesh_path(ob["file"], path))
            tris.append(v)
            tri_obj.append([i] * len(v))
            tri_mat.append([mat] * len(v))
            tri_mesh.append([True] * len(v))
        elif kind == "plane":
            planes.append((_vec(ob["point"]), _vec(ob["normal"]), i, mat))
        elif kind == "sphere":
            spheres.append((_vec(ob["center"]), float(ob["radius"]), i, mat))
        else:
            raise ValueError(f"object #{i}: unknown type {kind!r}")
    mats = raw["materials"]
    lights = raw["lights"]
    cam = raw["camera"]

    def col(rows, k, shape, dtype=np.float32):
        return (np.asarray([r[k] for r in rows], dtype).reshape(shape)
                if rows else np.zeros(shape, dtype))

    return SceneData(
        tris=(np.concatenate(tris) if tris
              else np.zeros((0, 3, 3), np.float32)),
        tri_obj=np.asarray(sum(tri_obj, []), np.int64),
        tri_mat=np.asarray(sum(tri_mat, []), np.int64),
        tri_mesh=np.asarray(sum(tri_mesh, []), bool),
        pl_point=col(planes, 0, (len(planes), 3)),
        pl_normal=col(planes, 1, (len(planes), 3)),
        pl_obj=col(planes, 2, (len(planes),), np.int64),
        pl_mat=col(planes, 3, (len(planes),), np.int64),
        sp_center=col(spheres, 0, (len(spheres), 3)),
        sp_radius=col(spheres, 1, (len(spheres),)),
        sp_obj=col(spheres, 2, (len(spheres),), np.int64),
        sp_mat=col(spheres, 3, (len(spheres),), np.int64),
        mat_color=np.stack([_vec(m["color"]) for m in mats]),
        mat_specular=np.asarray([m.get("specular", 0.3) for m in mats],
                                np.float32),
        mat_reflect=np.asarray([m.get("reflect", 0.0) for m in mats],
                               np.float32),
        mat_phong=np.asarray([m.get("phong", 32.0) for m in mats],
                             np.float32),
        mat_transparency=np.asarray([m.get("transparency", 0.0)
                                     for m in mats], np.float32),
        light_point=np.stack([_vec(l["direction"] if l["type"] == "sun"
                                   else l.get("point", l.get("position")))
                              for l in lights]).reshape(-1, 3),
        light_sun=np.asarray([l["type"] == "sun" for l in lights], bool),
        light_color=np.stack([_vec(l.get("color", (1.0, 1.0, 1.0)))
                              for l in lights]).reshape(-1, 3),
        eye=_vec(cam.get("eye", (0, 0, 0))),
        look=_vec(cam.get("look", (0, 0, 1))),
        up=_vec(cam.get("up", (0, 1, 0))),
        width=int(cam.get("width", 1920)),
        height=int(cam.get("height", 1080)),
        ambient=float(np.float32(cam.get("ambient", 0.1))),
        n_objects=len(raw["objects"]),
    )
