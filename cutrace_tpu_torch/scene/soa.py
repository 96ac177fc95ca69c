"""Scene -> structure-of-arrays tensors (counterpart of cutrace_tpu.scene.soa).

Every primitive kind gets its own SoA buffer; mesh triangles are flattened
into the global triangle buffer in file order with a `tri_mesh` slot, and
every primitive carries its scene `obj` index so a (t, obj) first-minimum
reproduces the reference's scan-order winner. Empty kinds are padded with
one never-hit sentinel row (valid=False) so every buffer is non-empty.

The leaves are built as numpy arrays exactly as the JAX package builds them
(`numpy_leaves`), then moved to a torch device (`soa_from_numpy`), so the
two packages see bit-identical scenes.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from cutrace_tpu_torch.scene import types as T


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """The device scene: tensor leaves plus static metadata (same fields as
    cutrace_tpu.scene.soa.SceneArrays)."""

    # triangles (standalone + flattened mesh triangles, scene order)
    tri_p1: torch.Tensor  # (T, 3) f32
    tri_p2: torch.Tensor  # (T, 3) f32
    tri_p3: torch.Tensor  # (T, 3) f32
    tri_mat: torch.Tensor  # (T,) i32
    tri_obj: torch.Tensor  # (T,) i32
    tri_mesh: torch.Tensor  # (T,) i32  mesh slot, -1 for standalone triangles
    tri_valid: torch.Tensor  # (T,) bool

    # planes
    pl_point: torch.Tensor  # (P, 3) f32
    pl_normal: torch.Tensor  # (P, 3) f32
    pl_mat: torch.Tensor  # (P,) i32
    pl_obj: torch.Tensor  # (P,) i32
    pl_valid: torch.Tensor  # (P,) bool

    # spheres
    sp_center: torch.Tensor  # (S, 3) f32
    sp_radius: torch.Tensor  # (S,) f32
    sp_mat: torch.Tensor  # (S,) i32
    sp_obj: torch.Tensor  # (S,) i32
    sp_valid: torch.Tensor  # (S,) bool

    # materials
    mat_color: torch.Tensor  # (K, 3) f32
    mat_specular: torch.Tensor  # (K,) f32
    mat_reflect: torch.Tensor  # (K,) f32
    mat_phong: torch.Tensor  # (K,) f32
    mat_transparency: torch.Tensor  # (K,) f32

    # lights: kind 0 = sun (vec = direction), 1 = point (vec = position)
    light_kind: torch.Tensor  # (L,) i32
    light_vec: torch.Tensor  # (L, 3) f32
    light_color: torch.Tensor  # (L, 3) f32
    light_valid: torch.Tensor  # (L,) bool

    # recentering origin for intersection math (midpoint of the authored
    # geometry and the eye; see cutrace_tpu.ops.intersect.cast_triangles)
    scene_center: torch.Tensor  # (3,) f32

    cam_eye: torch.Tensor  # (3,) f32
    cam_forward: torch.Tensor  # (3,) f32
    cam_right: torch.Tensor  # (3,) f32
    cam_up: torch.Tensor  # (3,) f32
    ambient: torch.Tensor  # () f32

    # -- static metadata --
    width: int
    height: int
    n_objects: int
    n_lights: int
    any_reflective: bool
    any_transparent: bool
    shadow_steps: int
    n_planes: int = 0
    n_spheres: int = 0
    chains_die: bool = True

    @property
    def device(self) -> torch.device:
        return self.tri_p1.device


META_NAMES = (
    "width", "height", "n_objects", "n_lights", "any_reflective",
    "any_transparent", "shadow_steps", "n_planes", "n_spheres", "chains_die",
)
LEAF_NAMES = tuple(
    f.name for f in dataclasses.fields(SceneArrays) if f.name not in META_NAMES
)

# Padding sentinels for empty primitive kinds: finite geometry parked far
# from any scene (valid=False keeps it from ever hitting).
_FAR = 1.0e8
_PAD_TRI = (
    np.asarray([[_FAR, 0.0, 0.0]], np.float32),
    np.asarray([[_FAR, 64.0, 0.0]], np.float32),
    np.asarray([[_FAR, 0.0, 64.0]], np.float32),
)
_PAD_PLANE = (
    np.asarray([[_FAR, _FAR, _FAR]], np.float32),  # point
    np.asarray([[0.0, 1.0, 0.0]], np.float32),  # normal
)
_PAD_SPHERE = np.asarray([[_FAR, -_FAR, _FAR]], np.float32)


def host_triangle_soup(scene: T.Scene):
    """The triangle rows of the SoA as numpy `(p1, p2, p3, valid)`, in
    scene_to_soa's order and with its sentinel padding; builds the cluster
    partition without a device readback."""
    tp1, tp2, tp3 = [], [], []
    for obj in scene.objects:
        if isinstance(obj, T.Triangle):
            tp1.append(obj.p1)
            tp2.append(obj.p2)
            tp3.append(obj.p3)
        elif isinstance(obj, T.Mesh):
            v = obj.vertices
            tp1.append(v[:, 0])
            tp2.append(v[:, 1])
            tp3.append(v[:, 2])
    if not tp1:
        return (_PAD_TRI[0].copy(), _PAD_TRI[1].copy(), _PAD_TRI[2].copy(),
                np.zeros(1, bool))
    p1 = np.concatenate([np.reshape(p, (-1, 3)) for p in tp1]).astype(np.float32)
    p2 = np.concatenate([np.reshape(p, (-1, 3)) for p in tp2]).astype(np.float32)
    p3 = np.concatenate([np.reshape(p, (-1, 3)) for p in tp3]).astype(np.float32)
    return p1, p2, p3, np.ones(len(p1), bool)


def numpy_leaves(scene: T.Scene, shadow_steps: int = 16):
    """The scene's leaves as numpy arrays and its static metadata:
    `(leaves: dict name -> ndarray, meta: dict name -> python scalar)`.

    The shadow march runs `meta["shadow_steps"]` steps: every occluder adds
    at least (1 - t_max) opacity, so ceil(1 / (1 - t_max)) steps reproduce
    the reference's unbounded march exactly; `shadow_steps` caps it."""
    tp1, tp2, tp3, tmat, tobj, tmesh = [], [], [], [], [], []
    n_meshes = 0
    plp, pln, plm, plo = [], [], [], []
    spc, spr, spm, spo = [], [], [], []

    for i, obj in enumerate(scene.objects):
        if isinstance(obj, T.Triangle):
            tp1.append(obj.p1)
            tp2.append(obj.p2)
            tp3.append(obj.p3)
            tmat.append(obj.mat_idx)
            tobj.append(i)
            tmesh.append(-1)
        elif isinstance(obj, T.Mesh):
            mesh_id = n_meshes
            n_meshes += 1
            for tri in obj.vertices:
                tp1.append(tri[0])
                tp2.append(tri[1])
                tp3.append(tri[2])
                tmat.append(obj.mat_idx)
                tobj.append(i)
                tmesh.append(mesh_id)
        elif isinstance(obj, T.Plane):
            plp.append(obj.point)
            pln.append(obj.normal)
            plm.append(obj.mat_idx)
            plo.append(i)
        elif isinstance(obj, T.Sphere):
            spc.append(obj.center)
            spr.append(obj.radius)
            spm.append(obj.mat_idx)
            spo.append(i)
        else:
            raise TypeError(f"unknown scene object {obj!r}")

    def pad3(lst, sentinel):
        return (np.stack(lst).astype(np.float32), np.ones(len(lst), bool)) if lst \
            else (sentinel.copy(), np.zeros(1, bool))

    def pad1(lst, dtype, fill=0):
        return np.asarray(lst if lst else [fill], dtype=dtype)

    tri_p1, tri_valid = pad3(tp1, _PAD_TRI[0])
    tri_p2, _ = pad3(tp2, _PAD_TRI[1])
    tri_p3, _ = pad3(tp3, _PAD_TRI[2])
    pl_point, pl_valid = pad3(plp, _PAD_PLANE[0])
    pl_normal, _ = pad3(pln, _PAD_PLANE[1])
    sp_center, sp_valid = pad3(spc, _PAD_SPHERE)

    mats = scene.materials or [T.SolidMaterial(color=(0.0, 0.0, 0.0))]
    mat_color = np.stack([m.color for m in mats]).astype(np.float32)
    mat_specular = np.asarray([m.specular for m in mats], np.float32)
    mat_reflect = np.asarray([m.reflect for m in mats], np.float32)
    mat_phong = np.asarray([m.phong for m in mats], np.float32)
    mat_transp = np.asarray([m.transparency for m in mats], np.float32)

    lights = scene.lights
    if lights:
        light_kind = np.asarray(
            [T.LIGHT_SUN if isinstance(l, T.Sun) else T.LIGHT_POINT for l in lights],
            np.int32,
        )
        light_vec = np.stack(
            [l.direction if isinstance(l, T.Sun) else l.point for l in lights]
        ).astype(np.float32)
        light_color = np.stack([l.color for l in lights]).astype(np.float32)
        light_valid = np.ones(len(lights), bool)
    else:
        light_kind = np.zeros(1, np.int32)
        light_vec = np.asarray([[0.0, 0.0, 1.0]], np.float32)
        light_color = np.zeros((1, 3), np.float32)
        light_valid = np.zeros(1, bool)

    cam = scene.camera
    forward, right, up = cam.basis()

    anchor_pts = [np.asarray(cam.eye, np.float32).reshape(1, 3)]
    if tp1:
        anchor_pts += [np.stack(tp1), np.stack(tp2), np.stack(tp3)]
    if spc:
        anchor_pts.append(np.stack(spc))
    if plp:
        anchor_pts.append(np.stack(plp))
    pts = np.concatenate([p.reshape(-1, 3) for p in anchor_pts]).astype(np.float64)
    scene_center = ((pts.min(0) + pts.max(0)) / 2.0).astype(np.float32)

    any_reflective = bool((mat_reflect >= 1e-6).any())
    any_transparent = bool((mat_transp >= 1e-6).any())
    if any_reflective and any_transparent:
        chains_die = True
    elif any_reflective:
        chains_die = bool((mat_reflect < 1e-6).any())
    elif any_transparent:
        chains_die = bool((mat_transp < 1e-6).any())
    else:
        chains_die = False
    t_max = float(mat_transp.max())
    if t_max >= 1.0:
        # the reference's march never terminates at transparency == 1
        exact_steps = shadow_steps + 1
    else:
        exact_steps = int(np.ceil(1.0 / (1.0 - t_max)))
    if exact_steps > shadow_steps:
        warnings.warn(
            f"scene has material transparency {t_max:.4f}: the exact shadow "
            f"march needs {exact_steps} steps but is capped at "
            f"{shadow_steps}; stacked transparent occluders may "
            f"under-accumulate shadow opacity. Raise "
            f"scene_to_soa(shadow_steps=) to restore exactness.",
            stacklevel=2,
        )

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    leaves = dict(
        tri_p1=f32(tri_p1),
        tri_p2=f32(tri_p2),
        tri_p3=f32(tri_p3),
        tri_mat=i32(pad1(tmat, np.int32)),
        tri_obj=i32(pad1(tobj, np.int32)),
        tri_mesh=i32(pad1(tmesh, np.int32)),
        tri_valid=np.asarray(tri_valid),
        pl_point=f32(pl_point),
        pl_normal=f32(pl_normal),
        pl_mat=i32(pad1(plm, np.int32)),
        pl_obj=i32(pad1(plo, np.int32)),
        pl_valid=np.asarray(pl_valid),
        sp_center=f32(sp_center),
        sp_radius=f32(pad1(spr, np.float32, 1)),
        sp_mat=i32(pad1(spm, np.int32)),
        sp_obj=i32(pad1(spo, np.int32)),
        sp_valid=np.asarray(sp_valid),
        mat_color=f32(mat_color),
        mat_specular=f32(mat_specular),
        mat_reflect=f32(mat_reflect),
        mat_phong=f32(mat_phong),
        mat_transparency=f32(mat_transp),
        light_kind=i32(light_kind),
        light_vec=f32(light_vec),
        light_color=f32(light_color),
        light_valid=np.asarray(light_valid),
        scene_center=f32(scene_center),
        cam_eye=f32(cam.eye),
        cam_forward=f32(forward),
        cam_right=f32(right),
        cam_up=f32(up),
        ambient=f32(cam.ambient),
    )
    meta = dict(
        width=cam.width,
        height=cam.height,
        n_objects=len(scene.objects),
        n_lights=len(lights),
        any_reflective=any_reflective,
        any_transparent=any_transparent,
        shadow_steps=min(max(exact_steps, 1), shadow_steps),
        n_planes=len(plp),
        n_spheres=len(spc),
        chains_die=chains_die,
    )
    return leaves, meta


def resolve_device(device="cuda") -> torch.device:
    """The device a port entry point runs on: the card unless the caller
    asks for the CPU. Asking for the card where there is none raises;
    nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def soa_from_numpy(leaves, meta, device="cuda") -> SceneArrays:
    """SceneArrays on `device` from numpy leaves (e.g. the JAX package's
    SceneArrays leaves read back with np.asarray) and static metadata."""
    dev = resolve_device(device)
    tensors = {
        name: torch.from_numpy(np.array(leaves[name], copy=True)).to(dev)
        for name in LEAF_NAMES
    }
    return SceneArrays(**tensors, **{name: meta[name] for name in META_NAMES})


def params_from_numpy(params, device="cuda"):
    """The port's parameter dict (diff.grad.extract_params) on `device`
    from numpy arrays, e.g. the JAX package's extract_params output read
    back with np.asarray: float32 tensors under the same keys."""
    dev = resolve_device(device)
    return {
        name: torch.from_numpy(np.array(value, np.float32, copy=True)).to(dev)
        for name, value in params.items()
    }


def soa_to(soa: SceneArrays, device) -> SceneArrays:
    """The same scene with every tensor leaf on `device`."""
    dev = resolve_device(device)
    return dataclasses.replace(
        soa, **{name: getattr(soa, name).to(dev) for name in LEAF_NAMES})


def scene_to_soa(scene: T.Scene, shadow_steps: int = 16,
                 device="cuda") -> SceneArrays:
    """Flatten a CPU scene into SceneArrays on `device`."""
    leaves, meta = numpy_leaves(scene, shadow_steps)
    return soa_from_numpy(leaves, meta, device)
