"""Scene file loader.

Equivalent of full_schema::load_file / load_from
(the reference's inc/loader.hpp:645-781) with the same error discipline:

  * element-level errors are logged to stderr, the element is skipped, and
    the load is flagged unsuccessful — but loading *continues*;
  * missing top-level "objects"/"lights"/"materials" arrays or "camera"
    object are logged and flag the load unsuccessful;
  * a JSON parse error yields an empty scene (and an unsuccessful flag —
    the reference leaves last_was_success stale here; we always set it).

Instead of the reference's mutable static `last_was_success` we return a
LoadResult; `load_file` remains the convenience entry point.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional

from cutrace_tpu_torch.scene import schema as S
from cutrace_tpu_torch.scene import types as T


@dataclasses.dataclass
class LoadResult:
    scene: T.Scene
    ok: bool
    errors: List[str]


def _err(errors: List[str], msg: str, quiet: bool) -> None:
    errors.append(msg)
    if not quiet:
        print(msg, file=sys.stderr)


def _load_elements(
    raw: Any,
    kind: str,
    schemas,
    ctx: Dict[str, Any],
    errors: List[str],
    compat: bool,
    quiet: bool,
) -> List[object]:
    out: List[object] = []
    for i, elem in enumerate(raw):
        try:
            if not isinstance(elem, dict):
                raise S.SchemaError("expected a JSON object")
            type_name = elem.get("type")
            if type_name is None:
                # compat: bunny_small.json has a type-less material
                if compat and kind == "material" and len(schemas) == 1:
                    type_name = schemas[0].name
                    print(
                        f"warning: {kind} #{i} has no 'type'; assuming "
                        f"'{type_name}' (legacy dialect)",
                        file=sys.stderr,
                    )
                else:
                    raise S.SchemaError("mandatory argument 'type' is missing")
            elif not isinstance(type_name, str):
                raise S.SchemaError("argument 'type' expects a string")
            sch = S.find_schema(schemas, type_name, compat)
            kwargs = S.load_args(sch, elem, compat)
            out.append(sch.ctor(ctx, **kwargs))
        except S.SchemaError as e:
            _err(errors, f"Error while loading {kind} #{i}: {e}", quiet)
    return out


def load_from(
    data: Dict[str, Any],
    scene_path: Optional[str] = None,
    compat: bool = True,
    quiet: bool = False,
) -> LoadResult:
    """Load a scene from a parsed JSON object (loader.hpp:679-760)."""
    errors: List[str] = []
    ctx = {"scene_path": scene_path}
    scene = T.Scene()

    for key, kind, schemas in (
        ("objects", "object", S.OBJECT_SCHEMAS),
        ("lights", "light", S.LIGHT_SCHEMAS),
        ("materials", "material", S.MATERIAL_SCHEMAS),
    ):
        raw = data.get(key)
        if not isinstance(raw, list):
            _err(errors, f"Could not find '{key}' array.", quiet)
            continue
        elems = _load_elements(raw, kind, schemas, ctx, errors, compat, quiet)
        if key == "objects":
            scene.objects = elems
        elif key == "lights":
            scene.lights = elems
        else:
            scene.materials = elems

    cam_raw = data.get("camera")
    if not isinstance(cam_raw, dict):
        _err(errors, "Could not find 'camera' object or it's invalid.", quiet)
    else:
        try:
            kwargs = S.load_args(S.CAMERA_SCHEMA, cam_raw, compat)
            scene.camera = S.CAMERA_SCHEMA.ctor(ctx, **kwargs)
        except S.SchemaError as e:
            _err(errors, f"Could not find 'camera' object or it's invalid: {e}.", quiet)

    scene.reindex()
    # Cross-reference validation (an out-of-bounds material index is UB in
    # the reference — silent clamping on device would mask the authoring
    # bug). Reported with the reference's element-error discipline.
    for msg in scene.validate():
        _err(errors, f"Error while validating scene: {msg}", quiet)
    return LoadResult(scene, ok=not errors, errors=errors)


def load_file(
    path: str, compat: bool = True, quiet: bool = False
) -> LoadResult:
    """Load a scene from a JSON file (loader.hpp:763-781), under the
    set-up span `scene.load` (utils.tracing)."""
    from cutrace_tpu_torch.utils import tracing

    with tracing.setup_span("scene.load"):
        try:
            with open(path, "r") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            msg = f"Error while loading file '{path}': {e}"
            if not quiet:
                print(msg, file=sys.stderr)
            return LoadResult(T.Scene(), ok=False, errors=[msg])
        if not isinstance(data, dict):
            msg = f"Error while loading file '{path}': expected a JSON object"
            if not quiet:
                print(msg, file=sys.stderr)
            return LoadResult(T.Scene(), ok=False, errors=[msg])
        return load_from(data, scene_path=path, compat=compat, quiet=quiet)


def load_scene(path: str, compat: bool = True) -> T.Scene:
    """Load a scene, raising on any error (for programmatic use)."""
    res = load_file(path, compat=compat, quiet=True)
    if not res.ok:
        raise S.SchemaError("; ".join(res.errors))
    return res.scene
