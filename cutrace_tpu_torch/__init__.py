"""cutrace_tpu_torch — the PyTorch/CUDA port of cutrace_tpu.

The JAX package `cutrace_tpu` stays the reference; this package mirrors its
module names so each counterpart is found at once:

  scene.soa          <- cutrace_tpu.scene.soa       (scene -> tensors)
  ops.intersect      <- cutrace_tpu.ops.intersect   (nearest-hit cast)
  ops.bvh            <- cutrace_tpu.ops.bvh         (cluster partition)
  ops.fused          <- cutrace_tpu.ops.fused       (whole-pipeline forward)
  ops.csrc/*.cu      <- the Pallas kernels, rewritten for Hopper
  render.shading     <- cutrace_tpu.render.shading  (Phong, bounce tree)
  render.renderer    <- cutrace_tpu.render.renderer (prepare / render)
  cli                <- cutrace_tpu.cli             (python -m entry)

The jax-free host layer (scene loading, schema, STL, the native library,
image encoders, the float64 golden renderer) is imported from `cutrace_tpu`,
never copied. Nothing here imports jax.
"""

__version__ = "0.1.0"

from cutrace_tpu.scene.loader import load_file, load_scene  # noqa: F401
