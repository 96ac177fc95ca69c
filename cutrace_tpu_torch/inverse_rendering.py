"""Inverse rendering: recover material colors, then the camera's eye, from
target images (counterpart of examples/inverse_rendering.py).

    python -m cutrace_tpu_torch.inverse_rendering [--scene PATH]
        [--steps 150] [--width 64] [--height 36] [--checkpoint-dir DIR]
        [--device cuda]

    torchrun --nproc_per_node N -m cutrace_tpu_torch.inverse_rendering

Renders scenes/sphere_plane.json at 64x36, bounce depth 2, as the target;
sets every material color to 0.5 and fits them back from the image alone
(`--steps` Adam steps, lr 5e-2, with checkpoints under --checkpoint-dir).
Then it renders the true scene at bounce depth 1, shakes the camera's eye
by (0.08, -0.05, 0.06) and fits the eye back through the look-at view
(diff.camera: every step keeps an orthonormal camera), 250 steps at lr
4e-3. It prints the losses, the recovered and true colors and the eye's
error. One process fits with no mesh; under torchrun with more than one
rank every rank calls it, over a mesh of world / 2 tile shards by 2
primitive shards when the world is even (else world by 1), and rank 0
prints. `--device cpu` runs the plain versions on the CPU (keep it
small: --width 16 --height 9 --steps 3).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib

import numpy as np
import torch

SCENE = pathlib.Path(__file__).resolve().parents[1] / "scenes" / \
    "sphere_plane.json"
# the eye's shake and the two fits' settings (examples/inverse_rendering.py)
EYE_SHAKE = (0.08, -0.05, 0.06)
COLOR_LR, COLOR_BOUNCES = 5e-2, 2
CAMERA_STEPS, CAMERA_LR, CAMERA_BOUNCES = 250, 4e-3, 1


def run(scene=SCENE, steps: int = 150, width: int = 64, height: int = 36,
        checkpoint_dir=None, device="cuda", mesh=None,
        camera_steps: int = CAMERA_STEPS, verbose: bool = False) -> dict:
    """The example's two fits. Returns a dict: `losses`, `params` (the
    color fit's), `true_colors`, `camera_losses`, `camera_params`,
    `true_eye` and `eye_error` (|recovered - true| per axis), numpy or
    lists on the host. `mesh` (parallel.sharding) trains over its ranks,
    on its device; `device` places the scene otherwise: the card unless
    the caller passes "cpu"."""
    from cutrace_tpu_torch.diff.camera import apply_look_at, camera_to_look_at
    from cutrace_tpu_torch.diff.grad import render_image_flat
    from cutrace_tpu_torch.parallel.train import fit
    from cutrace_tpu_torch.scene.loader import load_scene
    from cutrace_tpu_torch.scene.soa import resolve_device, scene_to_soa

    dev = mesh.device if mesh is not None else resolve_device(device)
    sc = load_scene(str(scene))
    sc.camera.width, sc.camera.height = width, height
    soa = scene_to_soa(sc, device=dev)
    with torch.no_grad():
        target, _, _ = render_image_flat(soa, COLOR_BOUNCES, 1e-3)
    # corrupt every material, then recover from the image alone
    corrupt = dataclasses.replace(
        soa, mat_color=torch.full_like(soa.mat_color, 0.5))
    params, losses = fit(corrupt, target, steps=steps, lr=COLOR_LR,
                         bounces=COLOR_BOUNCES, param_filter=("mat_color",),
                         verbose=verbose, checkpoint_dir=checkpoint_dir,
                         device=dev, mesh=mesh)
    # the camera, through the look-at view: perturb the eye, recover it
    true_cam = camera_to_look_at(soa)
    shake = torch.tensor(EYE_SHAKE, dtype=torch.float32, device=dev)
    shaken = apply_look_at(soa, dict(true_cam,
                                     cam_eye=true_cam["cam_eye"] + shake))
    with torch.no_grad():
        target_b1, _, _ = render_image_flat(soa, CAMERA_BOUNCES, 1e-3)
    cam_params, cam_losses = fit(shaken, target_b1, steps=camera_steps,
                                 lr=CAMERA_LR, bounces=CAMERA_BOUNCES,
                                 param_filter=("cam_eye",),
                                 camera="look_at", device=dev, mesh=mesh)
    true_eye = true_cam["cam_eye"].cpu().numpy()
    eye = cam_params["cam_eye"].cpu().numpy()
    return {"losses": losses,
            "params": {k: v.cpu().numpy() for k, v in params.items()},
            "true_colors": soa.mat_color.cpu().numpy(),
            "camera_losses": cam_losses,
            "camera_params": {k: v.cpu().numpy()
                              for k, v in cam_params.items()},
            "true_eye": true_eye, "eye_error": np.abs(eye - true_eye)}


def main(argv=None, camera_steps: int = CAMERA_STEPS) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cutrace_tpu_torch.inverse_rendering")
    ap.add_argument("--scene", default=str(SCENE))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=36)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from cutrace_tpu_torch.parallel import multihost
    from cutrace_tpu_torch.parallel.sharding import make_mesh
    from cutrace_tpu_torch.render import renderer
    from cutrace_tpu_torch.scene.soa import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh, lead = None, True
    if world > 1:
        multihost.initialize(device=args.device)
        n_prims = 2 if world % 2 == 0 else 1
        mesh = make_mesh(world // n_prims, n_prims, device=args.device)
        lead = torch.distributed.get_rank() == 0
        tiles = world // n_prims
    else:
        tiles = n_prims = 1
    try:
        if lead:
            print(f"mesh: {tiles} tile shards x {n_prims} primitive shards")
        out = run(args.scene, args.steps, args.width, args.height,
                  args.checkpoint_dir, args.device, mesh, camera_steps,
                  verbose=lead)
        if lead:
            losses, cam_losses = out["losses"], out["camera_losses"]
            print(f"\nloss: {losses[0]:.6f} -> {losses[-1]:.2e}")
            print("recovered material colors:")
            print(out["params"]["mat_color"].round(3))
            print("true material colors:")
            print(out["true_colors"].round(3))
            print(f"\ncamera: loss {cam_losses[0]:.6f} -> "
                  f"{cam_losses[-1]:.2e}, eye error "
                  f"{out['eye_error'].round(4)}")
    finally:
        if mesh is not None:
            # the step programs' graphs hold NCCL collectives: free them
            # before the group goes
            renderer.drop_programs()
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
