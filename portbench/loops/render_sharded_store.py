"""The loop of loops/render_sharded.py, its ranks started another way:
joined through a store that this process holds, and each on cores of
its own.

render_sharded.run picks a free port, closes it and leaves rank 0 to
listen on it once its imports are done, seconds later. The other ranks
retry their connections meanwhile, each from a new local port, and one
of them can take that port: rank 0 then exits with EADDRINUSE (on four
H100s, 1 start of 27). Here the TCP store is opened first, on a port the
system picks, and every rank joins it as a client
(TORCHELASTIC_USE_AGENT_STORE, as torchrun's agent does), so no rank
binds a port by number.

Each rank is started on its own share of this process's cores, with as
many OpenMP and torch threads as it has cores, so the ranks' set-up and
their frames' host work do not preempt one another.

The frames, the window and the check are render_sharded's: each rank
runs its rank_main (python -m portbench.rank).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

from torch.distributed import TCPStore

from portbench import harness
from portbench.loops import render_sharded


def core_shares(cores, world: int) -> list[set[int]]:
    """`cores` cut into `world` contiguous shares, as even as they go;
    every share is all of them when there are fewer cores than ranks."""
    cores = sorted(cores)
    if len(cores) < world:
        return [set(cores)] * world
    return [set(cores[len(cores) * r // world:len(cores) * (r + 1) // world])
            for r in range(world)]


def run(ctx: harness.Context, device: str = "cuda", seeds=None):
    """Rank 0's result of the run; with `seeds` (calibration) a list of
    results, one a seed, each with a window of ctx.seconds."""
    world = ctx.mix["tiles"] * ctx.mix["prims"]
    store = TCPStore("127.0.0.1", 0, is_master=True)
    mine = os.sched_getaffinity(0)
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for rank, cores in enumerate(core_shares(mine, world)):
                env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(store.port),
                           WORLD_SIZE=str(world), RANK=str(rank),
                           LOCAL_RANK=str(rank),
                           TORCHELASTIC_USE_AGENT_STORE="True",
                           OMP_NUM_THREADS=str(len(cores)))
                args = {"workload": ctx.workload, "cfg": ctx.cfg,
                        "mix": ctx.mix, "seeds": seeds or [ctx.seed],
                        "seconds": ctx.seconds, "trace": ctx.trace,
                        "t0_wall": ctx.t0_wall, "device": device,
                        "out": os.path.join(tmp, "rank0.json")}
                # the rank inherits this thread's cores
                os.sched_setaffinity(0, cores)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "portbench.rank",
                     json.dumps(args)], env=env))
            os.sched_setaffinity(0, mine)
            deadline = time.monotonic() + render_sharded.JOIN_S
            for p in procs:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                if rc != 0:
                    raise RuntimeError(f"a rank exited with {rc}")
        finally:
            os.sched_setaffinity(0, mine)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        with open(os.path.join(tmp, "rank0.json")) as f:
            outs = json.load(f)
    return outs if seeds else outs[0]
