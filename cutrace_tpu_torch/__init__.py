"""cutrace_tpu_torch — the PyTorch/CUDA port of cutrace_tpu.

The JAX package `cutrace_tpu` stays the reference; this package mirrors its
module names so each counterpart is found at once:

  vecmath, scene.{types,schema,loader,stl,mesh_io}, io.images, native
                     <- the same modules of cutrace_tpu (host layer, copied)
  scene.soa          <- cutrace_tpu.scene.soa       (scene -> tensors)
  ops.intersect      <- cutrace_tpu.ops.intersect   (nearest-hit cast)
  ops.bvh            <- cutrace_tpu.ops.bvh         (cluster partition)
  ops.fused          <- cutrace_tpu.ops.fused       (whole-pipeline forward,
                                                     topology codes)
  ops.replay         <- cutrace_tpu.ops.replay      (code-driven replay)
  ops.replay_vjp     <- cutrace_tpu.ops.replay_vjp  (the replay backward)
  ops.csrc/*.cu      <- the Pallas kernels, rewritten for Hopper
  render.shading     <- cutrace_tpu.render.shading  (Phong, bounce tree)
  render.renderer    <- cutrace_tpu.render.renderer (prepare / render,
                                                     the frame programs)
  diff.{grad,camera,checkpoint}
                     <- cutrace_tpu.diff            (gradients, look-at
                                                     camera, checkpoints)
  parallel.{sharding,multihost,train}
                     <- cutrace_tpu.parallel        (meshes over
                                                     torch.distributed, fit)
  utils.profiling    <- cutrace_tpu.utils.profiling (timings, traces)
  utils.tracing      the port's spans, counters and device phase marks
  cli                <- cutrace_tpu.cli             (python -m entry)

Nothing here imports jax or cutrace_tpu. Entry points run on the CUDA card
unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from cutrace_tpu_torch.scene.loader import load_file, load_scene  # noqa: F401
