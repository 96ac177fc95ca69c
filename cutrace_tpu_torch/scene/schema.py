"""Declarative JSON scene schema.

Runtime replacement for the reference's compile-time template schema
engine (the reference's inc/loader.hpp:62-781): where the reference encodes
argument names/types/defaults as template parameters and dispatches on the
JSON "type" key through a recursive template search, we keep one runtime
table of `TypeSchema` rows. Same JSON dialect, same mandatory/optional
semantics, same defaults (default_schema.hpp:408-453, 815-822, 888-897).

Dialect-compat notes (documented deviations):
  * `"model"` is accepted as an alias for `"mesh"` and `"position"` for a
    point light's `"point"` — the bundled `bunny_small.json` still uses the
    older dialect of schema.md and fails to load under the reference code.
  * a material with no `"type"` key defaults to `"solid"` (bunny_small.json
    again). Both compat paths emit a warning; `strict=True` restores the
    reference's reject-the-element behavior.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from cutrace_tpu_torch.scene import types as T
from cutrace_tpu_torch.scene.mesh_io import load_mesh
from cutrace_tpu_torch.scene.stl import resolve_mesh_path


class SchemaError(Exception):
    """Equivalent of json_error (json_helpers.hpp:20-22)."""


_MANDATORY = object()


@dataclasses.dataclass(frozen=True)
class Arg:
    """One schema argument (loader_argument, loader.hpp:62-172)."""

    name: str
    type: str  # "float" | "int" | "str" | "vec3"
    default: Any = _MANDATORY
    aliases: Tuple[str, ...] = ()

    @property
    def mandatory(self) -> bool:
        return self.default is _MANDATORY


@dataclasses.dataclass(frozen=True)
class TypeSchema:
    """One constructible scene element type (object_schema / light_schema /
    material_schema, loader.hpp:211-502)."""

    name: str
    ctor: Callable[..., object]
    args: Tuple[Arg, ...]
    aliases: Tuple[str, ...] = ()

    def matches(self, type_name: str, compat: bool) -> bool:
        return type_name == self.name or (compat and type_name in self.aliases)


def _coerce(arg: Arg, value: Any):
    """JSON value -> python value (json_helpers.hpp:88-139: all JSON
    numerics arrive as double and are narrowed per-argument)."""
    if arg.type == "float":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaError(f"argument '{arg.name}' expects a number")
        return float(value)
    if arg.type == "int":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SchemaError(f"argument '{arg.name}' expects a number")
        return int(value)
    if arg.type == "str":
        if not isinstance(value, str):
            raise SchemaError(f"argument '{arg.name}' expects a string")
        return value
    if arg.type == "vec3":
        if (
            not isinstance(value, (list, tuple))
            or len(value) != 3
            or any(isinstance(v, bool) or not isinstance(v, (int, float)) for v in value)
        ):
            raise SchemaError(f"argument '{arg.name}' expects an array of 3 numbers")
        return np.asarray(value, dtype=np.float32)
    raise AssertionError(f"unknown arg type {arg.type}")


def load_args(schema: TypeSchema, obj: Dict[str, Any], compat: bool) -> Dict[str, Any]:
    """Gather ctor kwargs with first-error-wins per element, like fmap_all
    (either.hpp:366-378): one missing mandatory argument fails the element."""
    out: Dict[str, Any] = {}
    for arg in schema.args:
        value = obj.get(arg.name, _MANDATORY)
        if value is _MANDATORY and compat:
            for alias in arg.aliases:
                if alias in obj:
                    value = obj[alias]
                    break
        if value is _MANDATORY:
            if arg.mandatory:
                raise SchemaError(
                    f"mandatory argument '{arg.name}' for type '{schema.name}' is missing"
                )
            value = arg.default
            if arg.type == "vec3":
                value = np.asarray(value, dtype=np.float32)
        else:
            value = _coerce(arg, value)
        out[arg.name] = value
    return out


# --- Default schema table (default_schema.hpp:461-905) ---------------------


def _mk_triangle(ctx, p1, p2, p3, material):
    return T.Triangle(p1, p2, p3, material)


def _mk_mesh(ctx, file, material):
    path = resolve_mesh_path(file, ctx.get("scene_path"))
    return T.Mesh(load_mesh(path), material, file=file)


def _mk_plane(ctx, point, normal, material):
    return T.Plane(point, normal, material)


def _mk_sphere(ctx, center, radius, material):
    return T.Sphere(center, radius, material)


def _mk_sun(ctx, direction, color):
    return T.Sun(direction, color)


def _mk_point(ctx, point, color):
    return T.PointLight(point, color)


def _mk_solid(ctx, color, specular, reflect, phong, transparency):
    return T.SolidMaterial(color, specular, reflect, phong, transparency)


def _mk_camera(ctx, eye, up, look, near_plane, far_plane, width, height, ambient):
    return T.Camera(eye, up, look, near_plane, far_plane, width, height, ambient)


_WHITE = (1.0, 1.0, 1.0)

OBJECT_SCHEMAS: Tuple[TypeSchema, ...] = (
    TypeSchema(
        "triangle",
        _mk_triangle,
        (
            Arg("p1", "vec3"),
            Arg("p2", "vec3"),
            Arg("p3", "vec3"),
            Arg("material", "int"),
        ),
    ),
    TypeSchema(
        "mesh",
        _mk_mesh,
        (Arg("file", "str"), Arg("material", "int")),
        aliases=("model",),
    ),
    TypeSchema(
        "plane",
        _mk_plane,
        (Arg("point", "vec3"), Arg("normal", "vec3"), Arg("material", "int")),
    ),
    TypeSchema(
        "sphere",
        _mk_sphere,
        (Arg("center", "vec3"), Arg("radius", "float"), Arg("material", "int")),
    ),
)

LIGHT_SCHEMAS: Tuple[TypeSchema, ...] = (
    TypeSchema(
        "sun",
        _mk_sun,
        (Arg("direction", "vec3"), Arg("color", "vec3", default=_WHITE)),
    ),
    TypeSchema(
        "point",
        _mk_point,
        (
            Arg("point", "vec3", aliases=("position",)),
            Arg("color", "vec3", default=_WHITE),
        ),
    ),
)

MATERIAL_SCHEMAS: Tuple[TypeSchema, ...] = (
    TypeSchema(
        "solid",
        _mk_solid,
        (
            Arg("color", "vec3"),
            Arg("specular", "float", default=0.3),
            Arg("reflect", "float", default=0.0),
            Arg("phong", "float", default=32.0),
            Arg("transparency", "float", default=0.0),
        ),
    ),
)

CAMERA_SCHEMA = TypeSchema(
    "camera",
    _mk_camera,
    (
        Arg("eye", "vec3", default=(0.0, 0.0, 0.0)),
        Arg("up", "vec3", default=(0.0, 1.0, 0.0)),
        Arg("look", "vec3", default=(0.0, 0.0, 1.0)),
        Arg("near_plane", "float", default=0.1),
        Arg("far_plane", "float", default=100.0),
        Arg("width", "int", default=1920),
        Arg("height", "int", default=1080),
        Arg("ambient", "float", default=0.1),
    ),
)


def find_schema(
    schemas: Sequence[TypeSchema], type_name: str, compat: bool
) -> TypeSchema:
    """Dispatch on the JSON "type" value (all_*_schema::load_from,
    loader.hpp:318-332)."""
    for s in schemas:
        if s.matches(type_name, compat):
            return s
    raise SchemaError(f"no type named '{type_name}' in schema")


def dump_schema(file=None) -> str:
    """Pretty-print the whole schema — the reference prints this as the
    help/error message when a scene fails to load
    (schema_view.hpp:166-203, main.cu:16-19)."""
    lines: List[str] = []

    def emit_args(schema: TypeSchema, indent: str):
        for a in schema.args:
            if a.mandatory:
                lines.append(f"{indent}'{a.name}' (mandatory): {a.type}")
            else:
                d = a.default
                if isinstance(d, tuple):
                    d = list(d)
                lines.append(f"{indent}'{a.name}' (optional): {a.type} = {d}")

    lines.append("Schema for scene files:")
    for title, schemas in (
        ("objects", OBJECT_SCHEMAS),
        ("lights", LIGHT_SCHEMAS),
        ("materials", MATERIAL_SCHEMAS),
    ):
        lines.append(f" -> Any of these {title}:")
        for s in schemas:
            alias = f" (alias: {', '.join(s.aliases)})" if s.aliases else ""
            lines.append(f"  -> type '{s.name}'{alias}:")
            emit_args(s, "    ")
    lines.append(" -> Camera:")
    emit_args(CAMERA_SCHEMA, "    ")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text
