"""The run's inputs, made from the configuration, the traffic mix and the
seed, and handed alike to the program and to the reference.

A configuration (configs/<name>.json) names a scene file under
portbench/, the image size, the bounce depth, the route (`accel`) and how
many times its meshes are midpoint-subdivided. The seed moves the eye and
each light by a seeded offset of at most the mix's `eye_jitter` and
`light_jitter` in each coordinate (one amount, or one a coordinate), and, for a fit, draws the target's
perturbation of the mix's parameter groups. Every draw is float32 numpy,
so both sides get the same numbers.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent


def read_json(kind: str, name: str) -> dict:
    """portbench/<kind>/<name>.json."""
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use (`stream`) of the run's seed; any whole
    number is a seed."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def subdivide(v: np.ndarray, levels: int) -> np.ndarray:
    """Midpoint 1:4 subdivision of an (N, 3, 3) triangle soup, `levels`
    times: the same surface in 4^levels as many triangles."""
    v = np.asarray(v, np.float32).reshape(-1, 3, 3)
    for _ in range(levels):
        p1, p2, p3 = v[:, 0], v[:, 1], v[:, 2]
        m12, m23, m31 = 0.5 * (p1 + p2), 0.5 * (p2 + p3), 0.5 * (p3 + p1)
        v = np.concatenate([np.stack([p1, m12, m31], 1),
                            np.stack([m12, p2, m23], 1),
                            np.stack([m31, m23, p3], 1),
                            np.stack([m12, m23, m31], 1)])
    return v


def scene_file(cfg: dict) -> str:
    return str(ROOT / cfg["scene"])


def offsets(mix: dict, seed: int, n_lights: int):
    """(eye offset (3,), light offsets (L, 3)) float32; a jitter is one
    amount or one a coordinate."""
    g = rng(seed, 0)
    eye = g.uniform(-1, 1, 3) * np.asarray(mix.get("eye_jitter", 0.0))
    lights = g.uniform(-1, 1, (n_lights, 3)) * np.asarray(
        mix.get("light_jitter", 0.0))
    return eye.astype(np.float32), lights.astype(np.float32)


def reference_scene(cfg: dict, mix: dict, seed: int):
    """The reference's SceneData of the run."""
    from portbench.reference.loader import load

    data = load(scene_file(cfg))
    data.width, data.height = cfg["width"], cfg["height"]
    levels = cfg.get("subdivide", 0)
    if levels:
        tris, objs, mats, mesh = [], [], [], []
        for obj in dict.fromkeys(data.tri_obj.tolist()):
            sel = data.tri_obj == obj
            v = data.tris[sel]
            if data.tri_mesh[sel][0]:
                v = subdivide(v, levels)
            tris.append(v)
            objs.append(np.full(len(v), obj, np.int64))
            mats.append(np.full(len(v), data.tri_mat[sel][0], np.int64))
            mesh.append(np.full(len(v), data.tri_mesh[sel][0]))
        data.tris = np.concatenate(tris)
        data.tri_obj, data.tri_mat = np.concatenate(objs), np.concatenate(mats)
        data.tri_mesh = np.concatenate(mesh)
    eye, lights = offsets(mix, seed, len(data.light_point))
    data.eye = data.eye + eye
    data.light_point = data.light_point + lights
    return data


def program_scene(cfg: dict, mix: dict, seed: int):
    """The program's Scene of the run (the program's own loader)."""
    from cutrace_tpu_torch import load_scene

    sc = load_scene(scene_file(cfg))
    sc.camera.width, sc.camera.height = cfg["width"], cfg["height"]
    for ob in sc.objects:
        if hasattr(ob, "vertices"):
            ob.vertices = subdivide(ob.vertices, cfg.get("subdivide", 0))
    eye, lights = offsets(mix, seed, len(sc.lights))
    sc.camera.eye = sc.camera.eye + eye
    for light, off in zip(sc.lights, lights):
        if hasattr(light, "point"):
            light.point = light.point + off
        else:
            light.direction = light.direction + off
    return sc


def perturbation(mix: dict, seed: int, data) -> dict:
    """The fit's target parameters: each group of the mix's `perturb`
    ({group: relative amount}) scaled by 1 + U(-a, a) elementwise, light
    positions moved by U(-a, a); float32, keyed as the reference's
    parameters."""
    g = rng(seed, 1)
    base = {"mat_color": data.mat_color, "mat_specular": data.mat_specular,
            "mat_reflect": data.mat_reflect, "mat_phong": data.mat_phong,
            "light_color": data.light_color, "light_vec": data.light_point}
    out = {}
    for name, amount in mix["perturb"].items():
        x = base[name]
        u = g.uniform(-amount, amount, x.shape)
        out[name] = (x + u if name == "light_vec" else x * (1 + u)
                     ).astype(np.float32)
    if "mat_color" in out:
        out["mat_color"] = np.clip(out["mat_color"], 0.0, 1.0)
    return out
