"""CPU-side scene value types.

Equivalent of the reference's CPU schema types and `cpu_scene`
(the reference's inc/cpu_types.hpp:40-60, inc/default_schema.hpp:404-906),
re-designed as plain dataclasses: where the reference keeps a
vector-of-variants, we keep one typed list per kind and preserve the
*original scene order* via an explicit `obj_index` so the renderer can
reproduce the reference's object-iteration tie-breaking exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from cutrace_tpu_torch import vecmath as vm

Vec3 = Tuple[float, float, float]


def _v(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


@dataclass
class Triangle:
    """A single triangle; corners expected counter-clockwise
    (default_schema.hpp:26-84)."""

    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray
    mat_idx: int
    obj_index: int = -1

    def __post_init__(self):
        self.p1, self.p2, self.p3 = _v(self.p1), _v(self.p2), _v(self.p3)


@dataclass
class Mesh:
    """A triangle soup loaded from a model file, with one material and one
    AABB (default_schema.hpp:89-154, 507-607). `vertices` is an (N, 3, 3)
    float32 array of triangle corners (p1, p2, p3)."""

    vertices: np.ndarray  # (N, 3, 3)
    mat_idx: int
    file: str = ""
    obj_index: int = -1

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float32).reshape(-1, 3, 3)

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]

    def bounding_box(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-mesh AABB (default_schema.hpp:573-586). An empty mesh yields
        the reference's 'incorrect' sentinel (+inf mins, -inf maxes,
        vector.hpp:181-186), which the slab test then never hits."""
        if self.num_triangles == 0:
            return (np.full(3, np.inf, np.float32), np.full(3, -np.inf, np.float32))
        return (
            self.vertices.min(axis=(0, 1)).astype(np.float32),
            self.vertices.max(axis=(0, 1)).astype(np.float32),
        )


@dataclass
class Plane:
    """Infinite plane: point + normal (default_schema.hpp:159-207)."""

    point: np.ndarray
    normal: np.ndarray
    mat_idx: int
    obj_index: int = -1

    def __post_init__(self):
        self.point, self.normal = _v(self.point), _v(self.normal)


@dataclass
class Sphere:
    """Sphere: center + radius (default_schema.hpp:212-257)."""

    center: np.ndarray
    radius: float
    mat_idx: int
    obj_index: int = -1

    def __post_init__(self):
        self.center = _v(self.center)
        self.radius = float(self.radius)


@dataclass
class Sun:
    """Directional light; shines *in* `direction`, so the direction towards
    the light is -direction and distance is infinite
    (default_schema.hpp:267-286)."""

    direction: np.ndarray
    color: np.ndarray

    def __post_init__(self):
        self.direction, self.color = _v(self.direction), _v(self.color)


@dataclass
class PointLight:
    """Point light (default_schema.hpp:291-311)."""

    point: np.ndarray
    color: np.ndarray

    def __post_init__(self):
        self.point, self.color = _v(self.point), _v(self.color)


@dataclass
class SolidMaterial:
    """Solid-color Phong material (default_schema.hpp:319-343, 778-822).

    Semantics carried into shading:
      diffuse  = color
      specular = specular * color      (get_phong_params, :326-332)
      reflecting / transparent iff factor >= 1e-6 (:334-335)
    """

    color: np.ndarray
    specular: float = 0.3
    reflect: float = 0.0
    phong: float = 32.0
    transparency: float = 0.0

    def __post_init__(self):
        self.color = _v(self.color)
        self.specular = float(self.specular)
        self.reflect = float(self.reflect)
        self.phong = float(self.phong)
        self.transparency = float(self.transparency)


@dataclass
class Camera:
    """Pinhole camera (default_schema.hpp:350-398, 834-898).

    `look_at` orthonormalization and ray generation follow
    default_schema.hpp:370-386: the screen spans 0.5 up/down at focal
    length 1 (implicit FOV), x scaled by aspect; near/far are unused.
    """

    eye: np.ndarray = field(default_factory=lambda: _v([0, 0, 0]))
    up: np.ndarray = field(default_factory=lambda: _v([0, 1, 0]))
    look: np.ndarray = field(default_factory=lambda: _v([0, 0, 1]))
    near: float = 0.1
    far: float = 100.0
    width: int = 1920
    height: int = 1080
    ambient: float = 0.1

    def __post_init__(self):
        self.eye, self.up, self.look = _v(self.eye), _v(self.up), _v(self.look)
        self.width, self.height = int(self.width), int(self.height)
        self.near, self.far = float(self.near), float(self.far)
        self.ambient = float(self.ambient)

    def basis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(forward, right, true_up), per look_at (default_schema.hpp:370-374)."""
        forward = vm.normalize(self.look - self.eye)
        right = vm.normalize(vm.cross(forward, self.up))
        true_up = vm.normalize(vm.cross(right, forward))
        return forward, right, true_up


# The kind tags used in SoA buffers and hit records.
KIND_TRIANGLE = 0
KIND_MESH = 1
KIND_PLANE = 2
KIND_SPHERE = 3

LIGHT_SUN = 0
LIGHT_POINT = 1


@dataclass
class Scene:
    """A full CPU scene (cpu_types.hpp:49-60).

    `objects` preserves the JSON order (a heterogeneous list); the typed
    accessors below split it per kind while keeping `obj_index`.
    """

    objects: List[object] = field(default_factory=list)
    lights: List[object] = field(default_factory=list)
    materials: List[SolidMaterial] = field(default_factory=list)
    camera: Camera = field(default_factory=Camera)

    def _of(self, cls):
        return [o for o in self.objects if isinstance(o, cls)]

    @property
    def triangles(self) -> List[Triangle]:
        return self._of(Triangle)

    @property
    def meshes(self) -> List[Mesh]:
        return self._of(Mesh)

    @property
    def planes(self) -> List[Plane]:
        return self._of(Plane)

    @property
    def spheres(self) -> List[Sphere]:
        return self._of(Sphere)

    def reindex(self) -> "Scene":
        """Stamp obj_index = position in `objects` (the reference's
        ray_cast iterates objects in this order, ray_cast.hpp:37-52)."""
        for i, o in enumerate(self.objects):
            o.obj_index = i
        return self

    def validate(self) -> List[str]:
        """Cross-reference checks the reference never does (it reads
        out-of-bounds materials, UB) — we report them instead."""
        errs = []
        n = len(self.materials)
        for i, o in enumerate(self.objects):
            if not (0 <= o.mat_idx < n):
                errs.append(
                    f"object #{i} references material {o.mat_idx} "
                    f"but only {n} materials are defined"
                )
        return errs
