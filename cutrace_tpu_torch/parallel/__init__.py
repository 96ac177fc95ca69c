"""Rendering and training over several devices (counterpart of
cutrace_tpu.parallel), one process per device over torch.distributed:
image tiles over the "tiles" axis of a mesh, the triangle buffer over its
"prims" axis (parallel.sharding); parallel.multihost starts the processes'
group."""

from cutrace_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    prepare_sharded,
    render_sharded,
    shard_scene,
)
from cutrace_tpu_torch.parallel.train import make_train_step  # noqa: F401
