"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--skip PHASE ...]

Run from the repository root on a machine with a CUDA card and nvcc. It
drives the port's main paths once and fails (non-zero exit, no result
line) if any phase fails:

  1. probe   torch / CUDA versions, the card's name and power limit, nvcc
  2. build   compile every kernel under cutrace_tpu_torch/ops/csrc/ for
             sm_90a, one nvcc per source, all started together
  3. parity  the forward kernel against its plain PyTorch version, same
             rays on the same card: triangle 20x20 b5, bunny / mirror /
             sphere_plane 480x270 b5 (K1's shared-memory instance). Gate
             (tests/test_fused.py _compare): np.isclose(atol=2e-4), no
             mismatch off the reference image's discontinuities, at most
             5 % of edge pixels. Then the 4k subdivided bunny (C=128,
             M=32, 393 KB of tables) at 480x270 b5: rendered with the
             launch counts reset just before (K1's global-memory instance
             must run), and that instance against the plain version under
             the gate with the 10 % edge budget of subdivided meshes
  4. timing  bunny 1920x1080 b5 frame through the kernel and through the
             plain version, CUDA events, in turns plain, kernel, plain;
             the first call of each is held to the parity gate at that
             size too; K1's global-memory instance on the same rays (the
             size rule overridden for that timing alone) between two
             timings of the shared-memory one; K1's tally, its root skips
             split by the tally of the frame without lights (the same
             nearest casts, no occlusion query)
  5. main    `python -m cutrace_tpu_torch scenes/bunny.json` (cli.main) at
             1920x1080 b5: three non-empty JPEGs, the forward kernel's
             launch count grew, and a library render is finite
  6. topo    the forward kernel with topology codes, on the parity scenes
             and bunny 1920x1080 b5: color, depth and normal bit-identical
             to the kernel without codes; the plain replay of the kernel's
             codes reproduces the kernel per ray (color and normal within
             1e-5, depth within 1e-4: tests/test_replay.py:51-54) off the
             edge mask below, at most 5 % of the edge pixels over; the
             kernel's codes equal the plain emitter's, no ray differing
             off the edge mask (the color image's discontinuities and the
             pixels next to a change of any code row), at most 5 % of the
             edge pixels
  7. vjp     the replay backward kernel against torch autograd of the plain
             replay (in ray chunks), on the same scenes, the kernel's
             codes and numpy-seeded cotangents (depth cotangents zero on
             misses): every non-camera parameter group, d_o and d_d under
             isclose(rtol=2e-3, atol=2e-3 * scale)
             (tests/test_replay_vjp.py:71-78); the instance
             (ops.replay_vjp.vjp_instance) and its compiled resources on
             each line; at 1080p the kernel's time alone (CUDA events
             around the library call) beside the wrapper's
  8. grad    one full gradient step, loss = mean((c - 0.9 c0)^2) over all
             19 parameter groups, on bunny 1920x1080 b5: finite gradients,
             both kernels launched; s/step by CUDA events (mean of 3 after
             a warm-up) and its parts; sphere_plane 1920x1080 b5 too
  9. train   fit on bunny 1920x1080 b5, mat_color perturbed by seeded
             noise, lr 5e-2, 5 steps: finite falling losses, a checkpoint
             saved, and a resumed fit continuing from it
 10. big-parity  K3 (the big-scene instance of the forward kernel) against
             the plain version: the subdivided bunny at 16k triangles
             480x270 b5 and 256k 160x90 b5, forward gate with the 10 %
             edge budget of subdivided meshes (tests/test_fused.py:173-188)
 11. big-topo / big-vjp  the topo and vjp phases on those two scenes: K3
             with codes (bits, replay, emitter gates), K2 at 256k (the
             triangle rows' exact sums in global memory)
 12. big-frame  a cutrace_tpu_torch.bigscene row at 16k, 64k, 256k and
             1M, 960x540 b5 (its frame finite and bit-equal to the eager
             loop's, render_eager), with K3's time, both bounds, launches,
             and slab tests, admitted and needed visits, sub-box tests and
             groups scanned a cast (and groups an admitted visit). The 256k
             and 1M frames (K3) against the 1k bunny's through K1 (the
             surface is the same): zero mismatches off the discontinuities
             and the rays whose topology codes differ between the two
             (triangles mapped to their 1k parents; at most 0.1 % of rays),
             at most 10 % of edge pixels; on those exempt rays, K3 against
             the plain version under the forward gate. At 1M (C=512,
             M=2048) K3 against the plain version at 80x45 b5 too
 13. big-grad  one gradient step over all 19 groups at 256k 960x540 b5:
             finite, K3 with codes and K2 launched; s/step and its parts
 14. cast    K4 against its plain version on bunny 480x270 primary rays
             and 65,536 seeded rays, on the bunny (M=16) and 256k
             (M=1024) partitions: orders equal but for knife edges (at
             most 0.1 % of rays), t within isclose(rtol 1e-5, atol
             1e-5 |o - o0|), each partition's instance (flat or tree)
             and its compiled resources; K4's time and bounds on the
             1080p primary rays in one launch, and its device time
             (torch.profiler, CUDA only) and bounds summed over its
             launches (65,536 rays for a nearest cast, 262,144 for the
             four lights' shadow casts) inside one --accel pallas bunny
             1080p b5 frame (the program's replays; its tallies through
             the eager loop, whose wrappers a replay does not call)
 15. pallas  the CLI with --accel pallas at bunny 1920x1080 b5: three
             JPEGs, K4 launched, K1/K3 not; the pallas render at 480x270
             b5 against the dense cast under the forward gate
 16. fallback  a transparent bunny (mesh transparency 0.5): at 160x90 b6
             (127 nodes) render takes the composable culling cast and
             matches brute force; at b5 (567 code rows, past the replay's
             512) a gradient step runs K1 forward and the composable
             backward through K4, within rtol 2e-3 of autograd of brute
             force
 17. program the frame programs (render on the card: CUDA graphs over
             K1/K3 and K4) against the eager loop (render_eager) on the
             same card: bunny 1920x1080 b5 fused (K1) and pallas (K4
             flat), mirror and sphere_plane 1920x1080 b5 fused (K1, one
             launch a frame, the frame finite), the 16k subdivided bunny
             480x270 b5 pallas (K4 tree) and fused (K3), the transparent
             bunny 160x90 b6 (the 127-node composable fallback): every
             bit of color, depth and normal equal, equal launch counts a
             frame (the pallas frame's K4 launches: chunks x levels x
             (1 + march steps)), a second
             render captures nothing and synchronizes with nothing
             (torch's sync debug mode "error"), a kept frame unchanged by
             an in-place change of a value the program reads, after which
             the program equals the eager loop again; the 1080p frames'
             first call (warm-up, capture, replay) with its peak and held
             memory, and CUDA-event times eager, program, eager
 18. step-program  the step programs (make_train_step / fit on the card:
             one CUDA graph a training step) against the op-by-op step on
             the same card: the train phase's fit (bunny 1920x1080 b5, 5
             steps) through the program and op by op (wall seconds in
             turns), one capture, 5 K1 with codes and 5 K2 launches in
             both, every loss and the final parameters bit-equal (a second
             op-by-op fit too); the same 5 steps from the same state
             (before each call the op-by-op side takes the program's
             parameters and Adam state): losses, gradients and updated
             parameters bit-equal; a checkpoint saved between replays
             holding the live parameters and a resumed fit whose first
             loss is a forward's at them. One 19-group step (lr 0) on
             bunny and sphere_plane 1920x1080 b5, the transparent bunny
             160x90 b5 (K1, composable backward through K4), bunny
             480x270 b5 "pallas" (K4 under autograd) and the 256k bunny
             960x540 b5 (K3 with codes, K2): first calls (eager; capture
             and replay; replay) with peak, held and pool memory, a replay
             with no sync (torch's sync debug mode "error") and the launch
             counts of an op-by-op step, gradients bit-equal to the
             op-by-op step's, CUDA-event times op by op, program, op by
             op. The inverse-rendering example's settings (sphere_plane
             64x36: 150 mat_color steps b2, 50 look-at camera steps b1):
             wall seconds op by op, program, op by op, every loss of the
             three bit-equal, and every step from the same state as
             above; then the example itself (inverse_rendering.run: 150
             color steps, 250 eye steps), each fit's last loss below its
             first
 19. determinism  same inputs, same bits, every count of differing
             elements printed before the gate: K2's sums alone
             (replay_vjp.exact_sum, 2**20 seeded terms into 17,102
             elements, specials included) bit-equal to their plain version
             and to themselves shuffled; K2 three times on the same codes
             and cotangents, bunny and sphere_plane 1920x1080 b5 and the
             256k bunny 960x540 b5 (d_rays, d_tbl, d_misc); the 19-group
             gradient three times as a step program and twice op by op
             (those three, the transparent bunny 160x90 b5 through K4,
             bunny 480x270 b5 "pallas"), every group bit-equal within each
             kind and between them; the example's two
             fits twice from scratch as programs, every loss and the final
             parameters; a 10-step bunny 480x270 b5 fit checkpointed at
             step 5 and resumed in a fresh fit call against an
             uninterrupted one, the final parameters and Adam state
 20. multi   the multi-device path (cutrace_tpu_torch.parallel): (a) one
             rank over NCCL (multihost.initialize, make_mesh(1, 1)):
             render_sharded of bunny 1920x1080 b5 (a ShardedScene) through
             one captured program (K1 and the image's all-gather inside),
             bit-identical to render and to render_sharded_eager, with
             their launches (K1 once a frame) and no sync in a replay
             (sync debug mode "error"), timed eager, program, program,
             eager; the prims route's chunk (sharded_tri_candidates over
             the world-1 mesh: K4 on the one shard, the candidates' two
             all-gathers, the combine) over bunny 480x270 b5 "pallas" as
             a captured chunk program (renderer._chunk_rows), bit-identical
             to its eager loop with equal launches, K4 launched, no sync
             in a replay; fit(mesh=...) 3 steps at the train phase's
             settings through one step program (its gradient sum
             captured: an all-gather, then the adds in rank order),
             losses within 1e-6 relative of the one-device
             fit, K1 with codes and K2 launched, and run twice: losses and
             parameters bit-equal. (b) two ranks on the one card
             over gloo (CUDA tensors go through the host for the
             collectives), each spawned with a deadline: the (2, 1) mesh
             on bunny 1920x1080 b5 (K1) and on the 16k subdivided bunny
             480x270 b5 (K3), bit-identical to render; the (1, 2) mesh on
             bunny 480x270 b5 with accel="pallas", K4 on each triangle
             shard, under the forward gate against the one-rank pallas
             render; one (2, 1) gradient step on bunny 480x270 b5 (K1
             codes, K2) within the vjp gate of the one-device step, and a
             2-step (2, 1) fit there that captures nothing (gloo); one
             (1, 2) gradient step there with accel="pallas" (K4 on each
             shard under autograd) within the vjp gate of the one-device
             culling-cast step. Each rank's launch counts are reset
             before each run and must grow; no render_sharded over gloo
             captures a program (renderer.CAPTURES unchanged).
             The sharded frames' CUDA-event times beside render's
 21. scaling  `python -m cutrace_tpu_torch.scaling` at bunny 1920x1080
             b5 over every card present (one torchrun a mesh size, the
             (n, 1) tiles mesh, "fused"), in a subprocess within
             SCALING_DEADLINE_S: one line a mesh size and the efficiency
             line, every line correct, no pixel off one rank's render, the
             work's invariance and balance measured from K1's tally, and
             every rank's sampled program frames (the timed ones, the
             counts set to 0 just before them) launching K1 once a frame
             and no other kernel. With two or more cards,
             `multihost --steps 3` fits on every card under
             NCCL_ALGO=allreduce:ring and under allreduce:tree (the
             all-reduce's algorithm; the all-gathers have no tree),
             through cutrace_tpu_torch.compare_fits: each run's step a
             program, its two program fits and two op-by-op fits
             bit-equal, and the same parameters and losses under both
             algorithms (the gradient sum's order is the code's, not
             NCCL's)
 22. result  a JSON line of per-kernel numbers (each with its launches
             in one replayed step of each step-program case), then the
             contract line {"ok": true, "device": {...}}

Each main path (the CLI render, the 4k bunny render, the gradient step,
fit, the 256k bigscene run, the 256k step, the --accel pallas CLI, the
sharded render and fit, each rank's frames of the scaling sweep) runs
with every kernel's launch count set to 0 just before it and read just
after; the counts of the result line come from those runs. A render or
a training step on the card replays a captured program, which calls no
wrapper: the program adds the counts its capture recorded on every
replay. Each bound is
given twice: the work these inputs need whatever the traversal ("bound":
the tally's needed cluster visits) and the kernel's own work
("bound_admitted": its slab tests and the slots it tested). `--skip` leaves
phases out while developing; the result line is printed only when nothing
was skipped. Nothing here imports jax.
"""

import argparse
import dataclasses
import io
import json
import multiprocessing
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
import types
from collections import Counter
from contextlib import redirect_stdout

import numpy as np
import torch

from cutrace_tpu_torch.utils.gates import (ATOL, EDGE_BUDGET,
                                           EDGE_BUDGET_SUBDIVIDED,
                                           code_edges, dilate,
                                           discontinuity_mask,
                                           gate, mismatch)
from cutrace_tpu_torch.utils.profiling import event_ms as cuda_ms
from cutrace_tpu_torch.utils.profiling import kernel_records
from cutrace_tpu_torch.utils.roofline import (cast_bound, forward_bound,
                                              tally_of, vjp_bound)

REPLAY_TOL = {"color": 1e-5, "depth": 1e-4, "normal": 1e-5}
VJP_RTOL = 2e-3
PARITY = (
    ("triangle.json", 20, 20, 5),
    ("bunny.json", 480, 270, 5),
    ("mirror.json", 480, 270, 5),
    ("sphere_plane.json", 480, 270, 5),
)
MAIN_SCENE = "bunny.json"  # authored at 1920x1080; the CLI renders b5
PHASES = ("parity", "timing", "main", "topo", "vjp", "grad", "train",
          "big-parity", "big-topo", "big-vjp", "big-frame", "big-grad",
          "cast", "pallas", "fallback", "program", "step-program",
          "determinism", "multi", "scaling")
# K3's parity cases: (subdivision levels, width, height), bounce depth 5
BIG_PARITY = ((2, 480, 270), (4, 160, 90))
# bigscene rows at 960x540 b5: 16k, 64k, 256k and 1M triangles
BIG_ROWS = (2, 3, 4, 5)
# share of rays that may take another path through the subdivided scene
KNIFE_RAY_BUDGET = 1e-3
# turns of a ray (radians) within which K3 and the plain version must
# reach each other's answer on an exempt ray off the discontinuity mask:
# a knife edge. 1e-7 is about two float32 steps of a unit direction.
KNIFE_TURNS = (1e-7, 1e-6)
# bigscene levels whose 960x540 frame is held against the 1k bunny's
BIG_FRAME_GATED = (4, 5)
# K3 against the plain version at 1M triangles, on a frame of this size
# (the plain version batches 63 rays there)
BIG_PARITY_1M = (80, 45)
# the 4k subdivided bunny (C=128, M=32) through K1's global-memory
# instance, at this size
K1_GLOBAL_PARITY = (480, 270)
CAST_RANDOM_RAYS = 65536
CAST_KNIFE_BUDGET = 1e-3  # share of rays allowed a knife-edge winner
FALLBACK_PLAIN_CHUNK = 512  # rays per chunk of the brute-force gradient
MULTI_DEADLINE_S = 240  # the two spawned ranks of the multi phase, together
SCALING_DEADLINE_S = 300  # the scaling phase's sweep
# NCCL_ALGO of the scaling phase's fits: the all-reduce's algorithm alone
# (the all-gathers, which have no tree, keep theirs)
NCCL_ALGOS = {"Ring": "allreduce:ring", "Tree": "allreduce:tree"}
FIT_RTOL = 1e-6  # fit(mesh=...) losses against the one-device fit
PLAIN_CHUNK = 262144  # rays per plain-replay chunk on the card
def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check_parity(label, soa, inverse, kern, plain, to_image,
                 edge_budget=EDGE_BUDGET):
    """Hold the kernel's (color, depth, normal) rays against the plain
    version's under the gate; print one line and return the largest
    off-edge |error| over color and normal."""
    kern, plain = (
        [x.cpu().numpy() for x in to_image(soa, inverse, *r)]
        for r in (kern, plain))
    stats = gate(plain, kern)
    phase("parity", label + " " + " ".join(
        f"{k}: off-edge {s[0]} edge {s[1]}/{s[2]} maxerr {s[3]:.2e}"
        for k, s in stats.items()))
    for k, (off, on, n_edges, _) in stats.items():
        if off:
            raise AssertionError(f"{label} {k}: {off} mismatches off "
                                 f"discontinuities")
        if on > edge_budget * max(n_edges, 1):
            raise AssertionError(f"{label} {k}: {on}/{n_edges} edge pixels "
                                 f"mismatch")
    return max(stats["color"][3], stats["normal"][3])


def reset_launches(fused, rv, pc):
    fused.LAUNCHES = fused.TOPO_LAUNCHES = rv.LAUNCHES = 0
    fused.GLOBAL_LAUNCHES = fused.GLOBAL_TOPO_LAUNCHES = 0
    fused.BIG_LAUNCHES = fused.BIG_TOPO_LAUNCHES = pc.LAUNCHES = 0


def read_launches(fused, rv, pc):
    return {"fused_forward": fused.LAUNCHES,
            "fused_forward_topo": fused.TOPO_LAUNCHES,
            "fused_forward_global": fused.GLOBAL_LAUNCHES,
            "fused_forward_global_topo": fused.GLOBAL_TOPO_LAUNCHES,
            "fused_forward_big": fused.BIG_LAUNCHES,
            "fused_forward_big_topo": fused.BIG_TOPO_LAUNCHES,
            "replay_vjp": rv.LAUNCHES,
            "cluster_cast": pc.LAUNCHES}


def bound_text(b):
    """One line of a forward_bound / cast_bound pair."""
    return (f"bound {b['bound'][0]:.4f} ms ({b['bound'][1]}; from admitted "
            f"visits {b['bound_admitted'][0]:.4f} ms, "
            f"{b['bound_admitted'][1]})")


def tally_text(tally):
    casts, visits, slabs, needed, sub_slabs, groups, root_skips = (
        int(x) for x in tally.tolist())
    n = max(casts, 1)
    text = (f"casts {casts}, a cast: slab tests {slabs / n:.2f}, admitted "
            f"visits {visits / n:.3f}, needed visits {needed / n:.3f}")
    if root_skips:
        text += f", root skips {root_skips / n:.3f}"
    if sub_slabs:
        text += (f", sub-box tests {sub_slabs / n:.2f}, groups scanned "
                 f"{groups / n:.3f} ({groups / max(visits, 1):.3f} an "
                 f"admitted visit), slot tests {groups * 32 / n:.2f}")
    return text


def root_split_text(tally, near):
    """K1's root skips a cast, split between nearest casts and occlusion
    queries: `near` is the tally of the same frame without its lights,
    which casts the same nearest rays and asks no occlusion query."""
    casts, skips = int(tally[0]), int(tally[6])
    n_casts, n_skips = int(near[0]), int(near[6])
    q_casts, q_skips = casts - n_casts, skips - n_skips
    return (f"root skips a nearest cast {n_skips / max(n_casts, 1):.3f} "
            f"({n_casts} casts), an occlusion query "
            f"{q_skips / max(q_casts, 1):.3f} ({q_casts} queries)")


def resources_text(res):
    return (f"{res['registers']} registers, {res['local_bytes']} local "
            f"bytes a thread, {res['static_shared_bytes']} static shared "
            f"bytes, at most {res['max_threads']} threads")


def library_ms(lib_name, fn_name, call, reps):
    """Mean ms of the library's `fn_name` launches alone inside `call()`
    run `reps` times: CUDA events around each library call, the
    wrapper's packing left out. Returns (kernel ms a call, launches a
    call)."""
    from cutrace_tpu_torch.ops import _build

    lib = _build.load_library(lib_name)
    load = _build.load_library
    events = []

    def timed(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        rc = getattr(lib, fn_name)(*args)
        ev[1].record()
        events.append(ev)
        return rc

    stand_in = types.SimpleNamespace(**{fn_name: timed})
    _build.load_library = (lambda name: stand_in if name == lib_name
                           else load(name))
    try:
        for _ in range(reps):
            call()
    finally:
        _build.load_library = load
    torch.cuda.synchronize()
    total = sum(a.elapsed_time(b) for a, b in events)
    return total / reps, len(events) / reps


def rays_to_pixels(soa, inverse, per_ray):
    """(R, ...) per-ray values in block order -> (H, W, ...) numpy."""
    n = soa.width * soa.height
    x = per_ray[inverse][:n].cpu().numpy()
    return x.reshape(soa.height, soa.width, *x.shape[1:])


def plain_replay(rp, soa, o, d, codes, bounces):
    with torch.no_grad():
        outs = [rp.replay_render_rays(soa, o[s:s + PLAIN_CHUNK],
                                      d[s:s + PLAIN_CHUNK],
                                      codes[s:s + PLAIN_CHUNK], 1e-3, bounces)
                for s in range(0, o.shape[0], PLAIN_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*outs))


def chunked_plain_vjp(rv):
    """The plain table-level VJP in ray chunks: table, light and ambient
    cotangents summed over chunks, ray cotangents concatenated."""
    def vjp(soa, table, lights, ambient, o, d, codes, cot, fudge, bounces):
        parts = []
        for s in range(0, o.shape[0], PLAIN_CHUNK):
            sl = slice(s, s + PLAIN_CHUNK)
            parts.append(rv.replay_vjp_plain(
                soa, table, lights, ambient, o[sl], d[sl], codes[sl],
                tuple(c[sl] for c in cot), fudge, bounces))
        return (sum(p[0] for p in parts), sum(p[1] for p in parts),
                sum(p[2] for p in parts), torch.cat([p[3] for p in parts]),
                torch.cat([p[4] for p in parts]))
    return vjp


def run_topo(label, prepared, bounces, fused, rp, rec):
    """The topo phase on one scene: returns (codes, o, d, max replay
    error) and, at 1080p, records kernel and plain times in `rec`."""
    from cutrace_tpu_torch.render.renderer import block_rays

    soa, accel, tables = prepared.soa, prepared.accel, prepared.tables
    o, d, inverse = block_rays(soa)
    base = fused.fused_render_rays(soa, accel, o, d, 1e-3, bounces,
                                   tables=tables)
    *topo, codes = fused.fused_render_rays(soa, accel, o, d, 1e-3, bounces,
                                           emit_topo=True, tables=tables)
    torch.cuda.synchronize()
    for name, a, b in zip(("color", "depth", "normal"), base, topo):
        if not torch.equal(a, b):
            raise AssertionError(f"{label} {name}: emit_topo changed the "
                                 f"forward's bits")
    rep = plain_replay(rp, soa, o, d, codes, bounces)
    t0 = time.perf_counter()
    plain_codes = fused.emit_topo_plain(soa, accel, o, d, 1e-3, bounces)
    torch.cuda.synchronize()
    emit_s = time.perf_counter() - t0
    # knife edges: the plain color image's discontinuities, and the pixels
    # next to a change of any code row in the plain emitter's codes (a
    # deep node's flipped winner may move the color by less than the
    # color mask's threshold)
    edges = (discontinuity_mask(rays_to_pixels(soa, inverse, base[0]))
             | code_edges(rays_to_pixels(soa, inverse, plain_codes)))
    n_edges = int(edges.sum())
    errs, over = {}, np.zeros(edges.shape, bool)
    for name, a, b in zip(("color", "depth", "normal"), topo, rep):
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise AssertionError(f"{label} {name}: replay misses differ")
        both = torch.isfinite(a) & torch.isfinite(b)
        err = torch.where(both, (a - b).abs(), 0.0)
        err = rays_to_pixels(soa, inverse, err.reshape(err.shape[0], -1)
                             .max(1).values)
        errs[name] = (float(err[~edges].max(initial=0.0)),
                      float(err.max(initial=0.0)))
        over |= err > REPLAY_TOL[name]
    phase("topo", f"{label} rows {codes.shape[1]}: bits identical; replay "
          f"max err off-edge / all: " + " ".join(
              f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in errs.items())
          + f"; rays over the tolerance: off-edge {int((over & ~edges).sum())}"
          f" edge {int((over & edges).sum())}/{n_edges}")
    # A knife-edge ray (a near-tangent sphere hit, a grazing reflection)
    # amplifies rounding by the inverse of its discriminant; such rays sit
    # on the edge mask, which gets the forward gate's 5 % edge budget.
    if (over & ~edges).any() or (over & edges).sum() > EDGE_BUDGET * max(
            n_edges, 1):
        raise AssertionError(f"{label}: the replay of the kernel's codes "
                             f"misses the kernel's values")
    differ = rays_to_pixels(soa, inverse, (plain_codes != codes).any(1))
    off, on = int((differ & ~edges).sum()), int((differ & edges).sum())
    phase("topo", f"{label}: codes vs plain emitter: off-edge {off} edge "
          f"{on}/{n_edges} rays differ (emitter {emit_s:.1f} s)")
    if off or on > EDGE_BUDGET * max(n_edges, 1):
        raise AssertionError(f"{label}: the kernel's codes differ from the "
                             f"plain emitter's")
    if rec is not None:
        topo_fn = lambda: fused.fused_render_rays(  # noqa: E731
            soa, accel, o, d, 1e-3, bounces, emit_topo=True, tables=tables)
        rec["topo_ms"] = cuda_ms(topo_fn, 10)
        rec["notopo_ms"] = cuda_ms(lambda: fused.fused_render_rays(
            soa, accel, o, d, 1e-3, bounces, tables=tables), 10)
        # the plain version: the plain forward (timed in phase timing, else
        # here) and the plain emitter (timed above)
        if "plain_ms" not in rec:
            rec["plain_ms"] = cuda_ms(lambda: fused.fused_render_rays_plain(
                soa, accel, o, d, 1e-3, bounces), 1)
        rec["topo_plain_ms"] = rec["plain_ms"] + emit_s * 1e3
        tally = tally_of(lambda t: fused._fused_forward_cuda(
            soa, tables, o, d, 1e-3, bounces, emit_topo=True, tally=t))
        rec["topo_bound"] = forward_bound(soa, accel, tables, o.shape[0],
                                          tally, codes.shape[1])
        phase("topo", f"{label}: kernel with codes {rec['topo_ms']:.3f} ms, "
              f"without {rec['notopo_ms']:.3f} ms, plain forward + emitter "
              f"{rec['topo_plain_ms']:.0f} ms; {tally_text(tally)}; "
              + bound_text(rec["topo_bound"]))
    return codes, o, d, max(errs["color"][0], errs["normal"][0])


def run_vjp(label, soa, o, d, codes, bounces, rp, rv, seed, rec):
    """The vjp phase on one scene: the kernel against the chunked plain
    version at the scene leaves. Returns the largest relative error."""
    from cutrace_tpu_torch.ops import _build

    r = o.shape[0]
    rng = np.random.default_rng(seed)
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(o.device)
           for s in ((r, 3), (r,), (r, 3))]
    plain = chunked_plain_vjp(rv)
    _, dep, _ = plain_replay(rp, soa, o, d, codes, bounces)
    cot[1] = torch.where(torch.isfinite(dep), cot[1], 0.0)
    cot = tuple(cot)
    got = rv.replay_vjp(soa, o, d, codes, cot, 1e-3, bounces)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rv.replay_vjp(soa, o, d, codes, cot, 1e-3, bounces,
                         tables_vjp=plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    pairs = [(f, got[0][f], want[0][f]) for f in rv.TABLE_FIELDS]
    pairs += [("o", got[1], want[1]), ("d", got[2], want[2])]
    for name, a, b in pairs:
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"{label} {name}: not finite")
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
        ok = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_RTOL * scale)
        if not ok.all():
            raise AssertionError(
                f"{label} {name}: {(~ok).sum()}/{a.size} mismatch, max "
                f"|diff| {np.abs(a - b).max():.3e} at scale {scale:.3e}")
        worst = max(worst, float(np.abs(a - b).max() / scale))
    inst = rv.vjp_instance(soa, bounces)
    res = _build.kernel_attributes("replay_vjp")
    phase("vjp", f"{label}: 15 groups + d_o, d_d within the gate; max "
          f"relative error {worst:.2e}; {inst.nodes} nodes, {inst.sums} "
          f"sums, {inst.block} threads, "
          f"{inst.shared_bytes} shared bytes a block; "
          + resources_text(res))
    if rec is not None:
        tables = rv.backward_tables(soa)
        kern = lambda: rv.vjp_tables(soa, *tables, o, d, codes, cot,  # noqa: E731
                                     1e-3, bounces)
        kern()
        rec["vjp_wrapper_ms"] = cuda_ms(kern, 10)
        rec["vjp_ms"], n = library_ms("replay_vjp", "cutrace_replay_vjp",
                                      kern, 10)
        if n != 1:
            raise AssertionError(f"{label}: {n} K2 launches a call")
        rec["vjp_plain_ms"] = plain_ms
        rec["vjp_bound"] = vjp_bound(soa, codes, bounces)
        rec["vjp_instance"] = dataclasses.asdict(inst)
        rec["vjp_resources"] = res
        phase("vjp", f"{label}: kernel {rec['vjp_ms']:.3f} ms (the library "
              f"call alone), wrapper {rec['vjp_wrapper_ms']:.3f} ms, plain "
              f"{plain_ms:.0f} ms; bound {rec['vjp_bound'][0]:.3f} ms "
              f"({rec['vjp_bound'][1]})")
    return worst


def grad_step_fn(prepared, bounces, tgrad):
    """A full gradient step over all 19 groups on the prepared scene:
    returns (step, params); step() returns the loss."""
    soa, accel = prepared.soa, prepared.accel
    with torch.no_grad():
        c0, _, _ = tgrad.render_image_flat(soa, bounces, 1e-3, accel)
    target = 0.9 * c0
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(soa).items()}

    def step():
        for p in params.values():
            p.grad = None
        loss = tgrad.render_loss(params, soa, target, bounces, 1e-3, accel)
        loss.backward()
        return loss

    return step, params


def grad_parts(prepared, bounces, fused, rv, tgrad):
    """CUDA-event milliseconds of a gradient step's parts, run one after
    another as the step runs them: camera rays, the kernels' tables, the
    forward with codes, the replay backward, and routing the cotangents to
    the leaves (tables and camera)."""
    from cutrace_tpu_torch.render.renderer import camera_rays

    soa, accel = prepared.soa, prepared.accel
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(soa).items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    s = tgrad.with_params(soa, params)
    n = s.width * s.height
    idx = torch.arange(n, device=s.device)
    o, d = camera_rays(s, idx % s.width, idx // s.width)
    ev[1].record()
    kt = fused.kernel_tables(s, accel)
    ins = rv.backward_tables(s)
    ev[2].record()
    c, dep, nrm, codes = fused._fused_forward_cuda(
        s, kt, o.detach(), d.detach(), 1e-3, bounces, emit_topo=True)
    ev[3].record()
    g_c = torch.randn_like(c)
    grads = rv.vjp_tables(s, *(x.detach() for x in ins), o.detach(),
                          d.detach(), codes, (g_c, None, None), 1e-3,
                          bounces)
    ev[4].record()
    torch.autograd.grad((*ins, o, d), list(params.values()), grads,
                        allow_unused=True)
    ev[5].record()
    ev[5].synchronize()
    names = ("camera", "tables", "forward_topo", "replay_vjp", "routing")
    return {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}


def big_prepared(m, levels, w, h):
    """The bunny with its mesh subdivided `levels` times, at w x h,
    prepared with accel="fused" on the card; returns (prepared, label)."""
    sc, n_tris = m.bigscene.subdivided_bunny(levels, w, h)
    prepared = m.prepare(sc, accel="fused", device="cuda", bounces=5)
    mm, c = prepared.accel.order.shape
    return prepared, f"bunny/{n_tris // 1000}k {w}x{h} b5 M={mm} C={c}"


def phase_k1_global(m, rec, launches):
    """The 4k subdivided bunny (C=128, M=32: 393 KB of tables, past a
    block's shared memory) at 480x270 b5: rendered through the entry point
    with every launch count set to 0 just before and read just after (K1's
    global-memory instance must run, its shared-memory one must not), then
    that instance against the plain version under the forward gate; its
    time, the plain version's and its bounds."""
    t0 = time.perf_counter()
    sc, n_tris = m.bigscene.subdivided_bunny(1, *K1_GLOBAL_PARITY)
    prepared = m.prepare(sc, accel="fused", device="cuda", bounces=5)
    soa, accel, tables = prepared.soa, prepared.accel, prepared.tables
    mm, c = accel.order.shape
    label = f"bunny/{n_tris // 1000}k {soa.width}x{soa.height} b5 M={mm} C={c}"
    if (mm, c) != (32, 128):
        raise AssertionError(f"{label}: not the C=128, M=32 partition")
    m.reset()
    m.render(prepared, bounces=5)
    torch.cuda.synchronize()
    launches["k1_global"] = counts = m.read()
    if counts["fused_forward_global"] < 1 or counts["fused_forward"]:
        raise AssertionError(f"{label}: launches {counts}, not K1's "
                             f"global-memory instance")
    o, d, inverse = m.block_rays(soa)
    kern = m.fused.fused_render_rays(soa, accel, o, d, 1e-3, 5, tables=tables)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = m.fused.fused_render_rays_plain(soa, accel, o, d, 1e-3, 5)
    torch.cuda.synchronize()
    rec["k1g_plain_ms"] = (time.perf_counter() - t1) * 1e3
    rec["k1g_err"] = check_parity(label, soa, inverse, kern, plain,
                                  m.to_image,
                                  edge_budget=EDGE_BUDGET_SUBDIVIDED)
    rec["k1g_ms"] = cuda_ms(lambda: m.fused.fused_render_rays(
        soa, accel, o, d, 1e-3, 5, tables=tables), 10)
    tally = tally_of(lambda t: m.fused._fused_forward_cuda(
        soa, tables, o, d, 1e-3, 5, tally=t))
    rec["k1g_bound"] = forward_bound(soa, accel, tables, o.shape[0], tally,
                                     0)
    rec["k1g_shape"] = label
    rec["k1g_resources"] = m.build.kernel_attributes("fused_forward",
                                                     m.fused._K1_GLOBAL)
    phase("parity", f"{label}: K1 global-memory instance "
          f"{m.fused.k1_shared_bytes(soa, tables)} bytes of tables (limit "
          f"{m.fused.shared_limit(o.device)}), launches {counts}; "
          f"{rec['k1g_ms']:.3f} ms, plain {rec['k1g_plain_ms']:.0f} ms; "
          f"{tally_text(tally)}; " + bound_text(rec["k1g_bound"])
          + "; " + resources_text(rec["k1g_resources"])
          + f"; {time.perf_counter() - t0:.1f} s")


def phase_big_parity(m, rec):
    """K3 against the plain version on the same rays, under the forward
    gate (subdivided meshes: the 10 % edge budget of
    tests/test_fused.py:173-188); returns {label: prepared}."""
    out = {}
    for levels, w, h in BIG_PARITY:
        t0 = time.perf_counter()
        prepared, label = big_prepared(m, levels, w, h)
        soa, accel = prepared.soa, prepared.accel
        o, d, inverse = m.block_rays(soa)
        before = m.fused.BIG_LAUNCHES
        kern = m.fused.fused_render_rays(soa, accel, o, d, 1e-3, 5,
                                         tables=prepared.tables)
        torch.cuda.synchronize()
        if m.fused.BIG_LAUNCHES != before + 1:
            raise AssertionError(f"{label}: K3 was not launched")
        t1 = time.perf_counter()
        plain = m.fused.fused_render_rays_plain(soa, accel, o, d, 1e-3, 5)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        err = check_parity(label, soa, inverse, kern, plain, m.to_image,
                           edge_budget=EDGE_BUDGET_SUBDIVIDED)
        rec["big_err"] = max(rec.get("big_err", 0.0), err)
        if levels == BIG_PARITY[-1][0]:
            fn = lambda: m.fused.fused_render_rays(  # noqa: E731
                soa, accel, o, d, 1e-3, 5, tables=prepared.tables)
            rec["big_ms"] = cuda_ms(fn, 10)
            rec["big_plain_ms"] = plain_s * 1e3
            tally = tally_of(lambda t: m.fused._fused_forward_cuda(
                soa, prepared.tables, o, d, 1e-3, 5, tally=t))
            rec["big_bound"] = forward_bound(soa, accel, prepared.tables,
                                             o.shape[0], tally, 0)
            rec["big_shape"] = label
            rec["big_resources"] = m.build.kernel_attributes(
                "fused_forward", m.fused._K3)
            phase("big-parity", f"{label}: K3 {rec['big_ms']:.3f} ms, plain "
                  f"{plain_s * 1e3:.0f} ms; {tally_text(tally)}; "
                  + bound_text(rec["big_bound"]) + "; "
                  + resources_text(rec["big_resources"]))
        out[label] = prepared
        phase("big-parity", f"{label} done in "
              f"{time.perf_counter() - t0:.1f} s")
        del kern, plain
    return out


def phase_big_topo_vjp(m, prepared_by_label, skip, rec):
    """K3 with codes: bits, plain replay and plain emitter gates
    (run_topo), then K2 against autograd of the plain replay (run_vjp),
    on each big-parity scene; the last one's times go to `rec`."""
    labels = list(prepared_by_label)
    for seed, label in enumerate(labels):
        t0 = time.perf_counter()
        prepared = prepared_by_label[label]
        r = None
        if label == labels[-1]:
            r = {"plain_ms": rec["big_plain_ms"]}
        before = m.fused.BIG_TOPO_LAUNCHES
        codes, o, d, err = run_topo(label, prepared, 5, m.fused, m.rp, r)
        if m.fused.BIG_TOPO_LAUNCHES <= before:
            raise AssertionError(f"{label}: K3 with codes was not launched")
        rec["big_topo_err"] = max(rec.get("big_topo_err", 0.0), err)
        if "big-vjp" not in skip:
            err = run_vjp(label, prepared.soa, o, d, codes, 5, m.rp, m.rv,
                          100 + seed, r)
            rec["big_vjp_err"] = max(rec.get("big_vjp_err", 0.0), err)
        if r is not None:
            rec["big_topo"] = r
        phase("big-topo", f"{label} done in {time.perf_counter() - t0:.1f} s")
        del codes, o, d


def subdivided_knife_edges(m, soa_1k, prepared, codes_1k, inverse):
    """(H, W) pixels whose ray takes another path through the subdivided
    scene than through the 1k one: a topology code differs once each
    triangle code is mapped to its 1k parent (mesh_io.subdivide keeps
    child i of the 1k mesh's triangle i % 1000 at index i) and plane and
    sphere codes to the 1k numbering. Such a ray met a face edge or a
    shadow edge of the 1k mesh within rounding: a knife edge."""
    soa = prepared.soa
    o, d, _ = m.block_rays(soa)
    *_, codes = m.fused.fused_render_rays(soa, prepared.accel, o, d, 1e-3, 5,
                                          emit_topo=True,
                                          tables=prepared.tables)
    t1, t2 = soa_1k.tri_p1.shape[0], soa.tri_p1.shape[0]
    _, nodes = m.rp.topo_layout(5, soa.any_reflective, soa.any_transparent,
                                soa.n_lights, soa.shadow_steps)
    rows = [cr for _, cr, _ in nodes]
    cast = codes[:, rows]
    codes[:, rows] = torch.where(cast >= t2, cast - t2 + t1,
                                 torch.where(cast >= 0, cast % t1, cast))
    differ = (codes != codes_1k).any(dim=1)
    return rays_to_pixels(soa, inverse, differ)


def knife_parity(m, label, prepared, knife, watch):
    """K3 against the plain version on the rays that `knife` exempts from
    the big-frame gate, under the forward gate (10 % edge budget): both run
    on those rays and on the pixels within two steps of them, so the plain
    image's discontinuity mask is exact at every exempt pixel. Each
    `watch` pixel (a color mismatch against the 1k frame off the 1k
    frame's mask) gets a line. Returns the largest |error| off the mask
    and off the knife-edge rays, as check_parity leaves out edges."""
    soa = prepared.soa
    if not knife.any():
        phase("big-frame", f"{label}: no exempt rays")
        return 0.0
    ys, xs = np.nonzero(dilate(knife, 2))
    o, d = m.camera_rays(soa, torch.from_numpy(xs).cuda(),
                         torch.from_numpy(ys).cuda())
    before = m.fused.BIG_LAUNCHES
    kern = m.fused.fused_render_rays(soa, prepared.accel, o, d, 1e-3, 5,
                                     tables=prepared.tables)
    torch.cuda.synchronize()
    if m.fused.BIG_LAUNCHES != before + 1:
        raise AssertionError(f"{label}: K3 was not launched")
    plain = m.fused.fused_render_rays_plain(soa, prepared.accel, o, d, 1e-3,
                                            5)
    stats, imgs, off = {}, {}, np.zeros(knife.shape, bool)
    for name, a, b in zip(("color", "depth", "normal"), plain, kern):
        pair = []
        for x in (a, b):
            x = x.cpu().numpy()
            img = np.full(knife.shape + x.shape[1:], np.nan, np.float32)
            img[ys, xs] = x
            pair.append(img)
        bad = mismatch(*pair) & knife
        edges = discontinuity_mask(pair[0]) & knife
        both = np.isfinite(pair[0]) & np.isfinite(pair[1])
        with np.errstate(invalid="ignore"):
            err = np.where(both, np.abs(pair[0] - pair[1]), 0.0)
        err = err.reshape(knife.shape + (-1,)).max(-1)
        stats[name] = (int((bad & ~edges).sum()), int((bad & edges).sum()),
                       int(edges.sum()),
                       float(err[knife & ~edges].max(initial=0.0)))
        imgs[name] = (err, edges)
        off |= bad & ~edges
    phase("big-frame", f"{label}: K3 vs plain on the {int(knife.sum())} "
          f"exempt rays ({ys.size} rays with their neighbours): " + " ".join(
              f"{k}: off-edge {v[0]} edge {v[1]}/{v[2]} maxerr {v[3]:.2e}"
              for k, v in stats.items()))
    err, edges = imgs["color"]
    for y, x in watch:
        phase("big-frame", f"{label}: pixel ({y}, {x}), a color mismatch "
              f"against the 1k frame: exempt {bool(knife[y, x])}, on the "
              f"plain image's mask {bool(edges[y, x])}, K3 vs plain color "
              f"|error| {float(err[y, x]):.2e}")
    # an off-edge disagreement passes only on a knife-edge ray: one where
    # either version, the ray turned by at most KNIFE_TURNS[-1], reaches
    # the other's answer (a hit within the slot test's rounding of a
    # shared edge, which one version's rounding sees through)
    pixels = np.argwhere(off)
    if len(pixels):
        at = {(y, x): i for i, (y, x) in enumerate(zip(ys, xs))}
        rows = torch.tensor([at[(y, x)] for y, x in pixels],
                            device=o.device)
        o_, d_ = o[rows], d[rows]
        turns = knife_turns(m, prepared, o_, d_, [x[rows] for x in kern],
                            [x[rows] for x in plain])
        *_, k_codes = m.fused.fused_render_rays(
            soa, prepared.accel, o_, d_, 1e-3, 5, emit_topo=True,
            tables=prepared.tables)
        p_codes = m.fused.emit_topo_plain(soa, prepared.accel, o_, d_, 1e-3,
                                          5)
        for j, ((y, x), turn) in enumerate(zip(pixels, turns)):
            differ = torch.nonzero(k_codes[j] != p_codes[j])[:, 0].tolist()
            phase("big-frame", f"{label}: pixel ({y}, {x}) off the mask: "
                  f"code rows {differ} differ from the plain emitter's; "
                  f"the two versions reach each other's answer at a turn "
                  f"of {turn} rad (None: not up to {KNIFE_TURNS[-1]}); "
                  + (probe_split(m, prepared, o_[j:j + 1], d_[j:j + 1],
                                 differ[0]) if differ else "same path"))
        if None in turns or len(turns) > EDGE_BUDGET_SUBDIVIDED * knife.sum():
            raise AssertionError(f"{label}: K3 departs from the plain "
                                 f"version off the mask on the exempt rays")
    for k, (_, on, n_edges, _) in stats.items():
        if on > EDGE_BUDGET_SUBDIVIDED * max(n_edges, 1):
            raise AssertionError(f"{label} {k}: K3 departs from the plain "
                                 f"version on the exempt rays' edges")
    return max(float(err[knife & ~edges & ~off].max(initial=0.0))
               for err, edges in (imgs["color"], imgs["normal"]))


def probe_split(m, prepared, o, d, row):
    """Where K3 and the plain emitter first split at a cast row of a
    chain (reflections only), walk the plain path to that node and ask K4
    (the slot test and cull K3 shares) for the node ray's nearest triangle
    over all clusters, and over the plain winner's cluster alone behind an
    unbounded box (the slot test alone); with the plain winner's smallest
    barycentric coordinate in float64. Returns a line."""
    soa, accel = prepared.soa, prepared.accel
    _, nodes = m.rp.topo_layout(5, soa.any_reflective, soa.any_transparent,
                                soa.n_lights, soa.shadow_steps)
    cast_rows = [cr for _, cr, _ in nodes]
    if soa.any_transparent or row not in cast_rows:
        return f"row {row} is not a cast row of a chain"
    tc = m.bvh.dense_candidates_fn(accel)
    for _ in range(cast_rows.index(row)):
        hit = m.I.ray_cast(soa, o, d, 1e-3, tc, need_uv=False)
        o = o + hit.t[:, None] * d
        d = m.sh._reflect(m.sh._normalize(d), m.sh._normalize(hit.normal))
    want = int(m.I.ray_cast(soa, o, d, 1e-3, tc, need_uv=False).prim[0])
    if not 0 <= want < soa.tri_p1.shape[0]:
        return f"node {cast_rows.index(row)}: the plain winner {want} " \
               f"is not a triangle"
    p1, p2, p3 = (x[want].double() for x in (soa.tri_p1, soa.tri_p2,
                                              soa.tri_p3))
    e1, e2, s0 = p2 - p1, p3 - p1, o[0].double() - p1
    h = torch.linalg.cross(d[0].double(), e2)
    q = torch.linalg.cross(s0, e1)
    a = (e1 * h).sum()
    u, v = float((s0 * h).sum() / a), float((d[0].double() * q).sum() / a)
    oc = (o - soa.scene_center).contiguous()
    d = d.contiguous()
    md = torch.full((1,), 1e-3, device=o.device)
    _, every = m.pc.cast_clusters(prepared.tables, oc, d, md)
    mi = int(torch.nonzero(accel.order == want)[0, 0])
    box = torch.tensor([[-1e30] * 3 + [1e30] * 3 + [0.0, 0.0]],
                       device=o.device)
    alone = m.pc.ClusterTables(
        tri=prepared.tables.tri[mi:mi + 1].contiguous(), aabb=box,
        tree=torch.cat([box, box]))
    _, one = m.pc.cast_clusters(alone, oc, d, md)
    return (f"node {cast_rows.index(row)}: the plain winner is triangle "
            f"{want} (smallest barycentric {min(u, v, 1 - u - v):.2e} in "
            f"float64); K4 finds {int(every[0])} over all clusters and "
            f"{int(one[0])} over cluster {mi} alone, unbounded")


def rays_close(a, b):
    """(R,) rays whose (color, depth, normal) agree under isclose(atol=
    ATOL), misses on both sides agreeing."""
    ok = torch.ones(a[0].shape[0], dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        close = torch.isclose(x, y, rtol=1e-5, atol=ATOL) | (
            torch.isinf(x) & torch.isinf(y))
        ok &= close.reshape(close.shape[0], -1).all(1)
    return ok


def knife_turns(m, prepared, o, d, kern, plain):
    """Per ray, the smallest turn in KNIFE_TURNS (radians; four ways round
    the ray) at which one version's (color, depth, normal) reaches the
    other's on the unturned ray: the plain version turned reaching `kern`,
    or K3 turned reaching `plain`; None if neither does."""
    n = o.shape[0]
    axis = torch.zeros_like(d)
    axis[:, 0] = (d[:, 0].abs() < 0.9).float()
    axis[:, 1] = 1.0 - axis[:, 0]
    u = torch.nn.functional.normalize(torch.linalg.cross(d, axis), dim=1)
    v = torch.linalg.cross(d, u)
    dirs = torch.cat([torch.nn.functional.normalize(d + eps * w, dim=1)
                      for eps in KNIFE_TURNS for w in (u, -u, v, -v)])
    k = dirs.shape[0] // n
    o_k = o.repeat(k, 1)
    turned_plain = m.fused.fused_render_rays_plain(
        prepared.soa, prepared.accel, o_k, dirs, 1e-3, 5)
    turned_kern = m.fused.fused_render_rays(
        prepared.soa, prepared.accel, o_k, dirs, 1e-3, 5,
        tables=prepared.tables)

    def repeat(xs):
        return [x.repeat(k, *[1] * (x.dim() - 1)) for x in xs]

    hit = (rays_close(turned_plain, repeat(kern))
           | rays_close(turned_kern, repeat(plain)))
    hit = hit.reshape(len(KNIFE_TURNS), 4, n).any(1)
    return [next((t for t, h in zip(KNIFE_TURNS, hit[:, j].tolist()) if h),
                 None) for j in range(n)]


def big_frame_gate(m, label, small, codes_1k, inverse, base_np, prepared,
                   frame, rec):
    """The subdivided bunny's frame through K3 against the 1k bunny's
    through K1 (the surface is the same): zero mismatches off the 1k
    frame's discontinuities and the rays that take another path (at most
    0.1 % of rays), at most 10 % of edge pixels; K3 against the plain
    version on those exempt rays (knife_parity)."""
    knife = subdivided_knife_edges(m, small.soa, prepared, codes_1k, inverse)
    frame_np = [x.cpu().numpy() for x in frame]
    plain_mask = gate(base_np, frame_np)
    stats = gate(base_np, frame_np, knife)
    phase("big-frame", f"{label} (K3) vs bunny/1k (K1): "
          f"{int(knife.sum())} rays take another path (codes differ from "
          f"the 1k frame's, triangles mapped to their 1k parents); "
          + " ".join(f"{k}: off-edge {v[0]} edge {v[1]}/{v[2]} (color mask "
                     f"alone: off-edge {plain_mask[k][0]})"
                     for k, v in stats.items()))
    watch = np.argwhere(mismatch(base_np[0], frame_np[0])
                        & ~discontinuity_mask(base_np[0]))
    if knife.sum() > KNIFE_RAY_BUDGET * knife.size:
        raise AssertionError(f"big-frame {label}: {int(knife.sum())} rays "
                             f"take another path")
    rec["big_err"] = max(rec.get("big_err", 0.0),
                         knife_parity(m, label, prepared, knife, watch))
    for k, (off, on, n_edges, _) in stats.items():
        if off or on > EDGE_BUDGET_SUBDIVIDED * max(n_edges, 1):
            raise AssertionError(f"big-frame {label} {k}: the subdivided "
                                 f"frame departs from the 1k frame")


def big_parity_1m(m, prepared, rec):
    """K3 against the plain version on the 1M bunny (C=512, M=2048) at
    BIG_PARITY_1M b5, the bigscene scene's camera at that size, under the
    forward gate with the 10 % edge budget."""
    w, h = BIG_PARITY_1M
    soa = dataclasses.replace(prepared.soa, width=w, height=h)
    accel = prepared.accel
    o, d, inverse = m.block_rays(soa)
    before = m.fused.BIG_LAUNCHES
    kern = m.fused.fused_render_rays(soa, accel, o, d, 1e-3, 5,
                                     tables=prepared.tables)
    torch.cuda.synchronize()
    if m.fused.BIG_LAUNCHES != before + 1:
        raise AssertionError("1M parity: K3 was not launched")
    t1 = time.perf_counter()
    plain = m.fused.fused_render_rays_plain(soa, accel, o, d, 1e-3, 5)
    torch.cuda.synchronize()
    rec["big1m_plain_ms"] = (time.perf_counter() - t1) * 1e3
    mm, c = accel.order.shape
    err = check_parity(f"bunny/{soa.tri_p1.shape[0] // 1000}k {w}x{h} b5 "
                       f"M={mm} C={c}", soa, inverse, kern, plain, m.to_image,
                       edge_budget=EDGE_BUDGET_SUBDIVIDED)
    rec["big_err"] = max(rec.get("big_err", 0.0), err)
    phase("big-frame", f"1M K3 vs plain at {w}x{h} b5: plain "
          f"{rec['big1m_plain_ms']:.0f} ms")


def phase_big_frame(m, smi, rec, launches):
    """bigscene rows with K3's kernel time, bound and launches per level;
    the 256k and 1M frames (K3) held against the 1000-triangle bunny's
    (K1) at 960x540 b5, and K3 against the plain version at 1M."""
    t0 = time.perf_counter()
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = 960, 540
    small = m.prepare(sc, accel="fused", device="cuda", bounces=5)
    base_np = [x.cpu().numpy() for x in m.render(small, bounces=5)]
    # the 1k frame's topology codes, to find the rays that took another
    # path through the subdivided scene
    o, d, inverse = m.block_rays(small.soa)
    *_, codes_1k = m.fused.fused_render_rays(
        small.soa, small.accel, o, d, 1e-3, 5, emit_topo=True,
        tables=small.tables)
    del o, d
    rows = []
    for levels in BIG_ROWS:
        m.reset()
        row, prepared, frame = m.bigscene.run(levels, 960, 540, 5, 3,
                                              "cuda")
        counts = m.read()
        if counts["fused_forward_big"] < 4:
            raise AssertionError(f"bigscene level {levels} missed K3: "
                                 f"{counts}")
        soa, accel = prepared.soa, prepared.accel
        label = (f"bunny/{row['triangles'] // 1000}k 960x540 b5 "
                 f"M={row['clusters']} C={row['cluster_size']}")
        check_finite(label, frame)
        bad = frames_differ(frame, m.render_eager(prepared, bounces=5))
        if bad:
            raise AssertionError(f"{label}: the program's frame differs "
                                 f"from the eager loop's in "
                                 + ", ".join(bad))
        if levels == 4:
            launches["big_frame"] = counts
        if levels in BIG_FRAME_GATED:
            big_frame_gate(m, label, small, codes_1k, inverse, base_np,
                           prepared, frame, rec)
        if levels == 5:
            big_parity_1m(m, prepared, rec)
        o, d, _ = m.block_rays(soa)
        fn = lambda: m.fused.fused_render_rays(  # noqa: E731
            soa, accel, o, d, 1e-3, 5, tables=prepared.tables)
        fn()
        row["kernel_ms"] = cuda_ms(fn, 10)
        tally = tally_of(lambda t: m.fused._fused_forward_cuda(
            soa, prepared.tables, o, d, 1e-3, 5, tally=t))
        row["tally"] = tally.tolist()
        casts = max(int(tally[0]), 1)
        row["slabs_per_cast"] = int(tally[2]) / casts
        row["visits_per_cast"] = int(tally[1]) / casts
        row["needed_per_cast"] = int(tally[3]) / casts
        row["sub_slabs_per_cast"] = int(tally[4]) / casts
        row["groups_per_cast"] = int(tally[5]) / casts
        row["groups_per_visit"] = int(tally[5]) / max(int(tally[1]), 1)
        row["slot_tests_per_cast"] = int(tally[5]) * 32 / casts
        b = forward_bound(soa, accel, prepared.tables, o.shape[0], tally, 0)
        row["bound_ms"], row["bound_by"] = b["bound"]
        row["bound_ms_admitted"], row["bound_by_admitted"] = (
            b["bound_admitted"])
        row["launches"] = counts["fused_forward_big"]
        rows.append(row)
        print("bigscene " + json.dumps(row), flush=True)
        del prepared, frame, o, d
        torch.cuda.empty_cache()
    rec["bigscene"] = rows
    phase("big-frame", f"done in {time.perf_counter() - t0:.1f} s ({smi})")


def phase_big_grad(m, prepared, smi, rec, launches):
    """One gradient step over all 19 groups at 256k 960x540 b5: K3 with
    codes and K2; s/step and its parts."""
    t0 = time.perf_counter()
    step, params = grad_step_fn(prepared, 5, m.tgrad)
    m.reset()
    loss = step().detach()
    torch.cuda.synchronize()
    launches["big_grad"] = m.read()
    if len(params) != 19:
        raise AssertionError(f"{len(params)} parameter groups, not 19")
    for k, p in params.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"big grad[{k}] missing or not finite")
    if (launches["big_grad"]["fused_forward_big_topo"] < 1
            or launches["big_grad"]["replay_vjp"] < 1):
        raise AssertionError(f"the 256k step missed a kernel: "
                             f"{launches['big_grad']}")
    rec["big_step_ms"] = cuda_ms(step, 3)
    first = grad_parts(prepared, 5, m.fused, m.rv, m.tgrad)
    rec["big_parts"] = grad_parts(prepared, 5, m.fused, m.rv, m.tgrad)
    phase("big-grad", "parts ms of a first call: " + json.dumps(
        {k: round(v, 3) for k, v in first.items()}))
    phase("big-grad", f"256k 960x540 b5: loss {loss.item():.6f}, 19 groups "
          f"finite, launches {launches['big_grad']}; "
          f"{rec['big_step_ms'] / 1e3:.4f} s/step (mean of 3 after a "
          f"warm-up); parts ms " + json.dumps(
              {k: round(v, 3) for k, v in rec["big_parts"].items()})
          + f"; {time.perf_counter() - t0:.1f} s ({smi})")
    del step, params


def cast_case(m, label, tables, o, d):
    """K4 against cast_clusters_plain on the same rays: orders equal
    except knife edges (kernel t within 1e-5 t of the plain winner's, at
    most 0.1 % of rays), t within isclose(rtol=1e-5, atol=1e-5 |o - o0|)
    where orders agree: t = (k - o.n) / (d.n) cancels terms of the size
    of the recentered origin, so a ray starting near a surface has a
    small t with an error of that size. Returns the largest |t|
    difference where they agree."""
    o = o.contiguous()
    md = torch.full((o.shape[0],), 1e-3, dtype=torch.float32, device="cuda")
    t_k, ord_k = m.pc.cast_clusters(tables, o, d, md)
    torch.cuda.synchronize()
    t_p, ord_p = m.pc.cast_clusters_plain(tables, o, d, md)
    same = ord_k == ord_p
    both = torch.isfinite(t_k) & torch.isfinite(t_p)
    knife = ~same & both & ((t_k - t_p).abs() <= 1e-5 * t_p.abs())
    if not bool((same | knife).all()):
        bad = int((~(same | knife)).sum())
        raise AssertionError(f"cast {label}: {bad} rays pick another "
                             f"triangle off the knife edges")
    if int(knife.sum()) > CAST_KNIFE_BUDGET * o.shape[0]:
        raise AssertionError(f"cast {label}: {int(knife.sum())} knife-edge "
                             f"rays")
    hit = same & torch.isfinite(t_p)
    diff = (t_k - t_p).abs()
    if not bool(torch.equal(torch.isinf(t_k[same]), torch.isinf(t_p[same]))):
        raise AssertionError(f"cast {label}: misses differ")
    scale = t_p.abs() + o.norm(dim=1)
    rel = hit & (diff > 1e-5 * t_p.abs())
    over = rel & (diff > 1e-5 * scale)
    phase("cast", f"{label}: {o.shape[0]} rays, {int(hit.sum())} hits, "
          f"knife edges {int(knife.sum())}, t past rtol 1e-5 "
          f"{int(rel.sum())}, past the gate {int(over.sum())}, max |dt| "
          f"{float(diff[hit].max()):.3e}, max |dt| / (t + |o - o0|) "
          f"{float((diff[hit] / scale[hit]).max()):.3e} (gate 1e-5)")
    if bool(over.any()):
        raise AssertionError(f"cast {label}: t differs past the gate")
    return float(diff[hit].max())


def phase_cast(m, big_prepared_256k, smi, rec):
    """K4 on seeded rays over the bunny partition (M=16) and the 256k
    partition, then its time and bound on the 1080p primary rays."""
    t0 = time.perf_counter()
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = 480, 270
    bunny = m.prepare(sc, accel="pallas", device="cuda")
    rng = np.random.default_rng(11)
    n = CAST_RANDOM_RAYS
    ro = torch.from_numpy(rng.normal(0.0, 0.6, (n, 3)).astype(np.float32))
    rd = rng.normal(size=(n, 3))
    rd = torch.from_numpy((rd / np.linalg.norm(rd, axis=1,
                                               keepdims=True)).astype(
        np.float32))
    err = 0.0
    rec["cast_resources"] = {}
    for label, prepared in (("bunny M=16", bunny),
                            ("bunny/256k M=1024", big_prepared_256k)):
        code = m.pc.k4_instance(prepared.tables)
        inst = "tree" if code == m.pc._K4_TREE else "flat"
        res = m.build.kernel_attributes("cluster_cast", code)
        rec["cast_resources"][inst] = res
        phase("cast", f"{label}: instance {inst}; " + resources_text(res))
        soa = prepared.soa
        o, d, _ = m.block_rays(bunny.soa)
        o = o - soa.scene_center
        err = max(err, cast_case(m, label + " primary 480x270",
                                 prepared.tables, o, d))
        err = max(err, cast_case(m, label + f" {n} seeded",
                                 prepared.tables, ro.cuda(), rd.cuda()))
    rec["cast_err"] = err
    tree = big_prepared_256k.tables
    if m.pc.k4_instance(tree) != m.pc._K4_TREE:
        raise AssertionError("the 256k partition does not take K4's tree "
                             "instance")
    ro, rd = ro.cuda(), rd.cuda()
    md = torch.full((n,), 1e-3, dtype=torch.float32, device="cuda")
    fn = lambda: m.pc.cast_clusters(tree, ro, rd, md)  # noqa: E731
    fn()
    total, launched = kernel_device_ms(lambda: [fn() for _ in range(10)],
                                       "cluster_cast_kernel")
    tally = tally_of(lambda t: m.pc.cast_clusters(tree, ro, rd, md, tally=t))
    rec["cast_tree"] = {"ms": total / launched,
                        "bound": cast_bound(tree, n, tally)}
    phase("cast", f"bunny/256k M=1024, {n} seeded rays, tree instance: K4 "
          f"{rec['cast_tree']['ms']:.4f} ms of device time a launch (mean "
          f"of {launched}); {tally_text(tally)}; "
          + bound_text(rec["cast_tree"]["bound"]) + f" ({smi})")
    sc = m.load_scene(m.scenes / "bunny.json")
    main = m.prepare(sc, accel="pallas", device="cuda")
    o, d, _ = m.block_rays(main.soa)
    o = (o - main.soa.scene_center).contiguous()
    md = torch.full((o.shape[0],), 1e-3, dtype=torch.float32, device="cuda")
    fn = lambda: m.pc.cast_clusters(main.tables, o, d, md)  # noqa: E731
    fn()
    rec["cast_ms"] = cuda_ms(fn, 10)
    t1 = time.perf_counter()
    m.pc.cast_clusters_plain(main.tables, o, d, md)
    torch.cuda.synchronize()
    rec["cast_plain_ms"] = (time.perf_counter() - t1) * 1e3
    tally = tally_of(lambda t: m.pc.cast_clusters(main.tables, o, d, md,
                                                  tally=t))
    rec["cast_bound"] = cast_bound(main.tables, o.shape[0], tally)
    phase("cast", f"bunny 1920x1080 primary rays M=16, one launch: K4 "
          f"{rec['cast_ms']:.3f} ms, plain {rec['cast_plain_ms']:.0f} ms; "
          f"{tally_text(tally)}; " + bound_text(rec["cast_bound"]))
    chunk = slice(0, 65536)
    rec["cast_chunk_plain_ms"] = cuda_ms(lambda: m.pc.cast_clusters_plain(
        main.tables, o[chunk], d[chunk], md[chunk]), 1)
    k4_in_frame(m, main, rec)
    phase("cast", f"done in {time.perf_counter() - t0:.1f} s ({smi})")


def kernel_device_ms(fn, kernel):
    """(device ms, records) of the kernels whose names hold `kernel` in
    one call of fn(), from a CUDA-only torch.profiler trace: their time
    on the card alone, with no host latency between launches."""
    durs = kernel_records(fn, kernel)
    return sum(durs), len(durs)


def k4_in_frame(m, prepared, rec):
    """K4 at the shape its path launches it: one bunny 1920x1080 b5
    render with accel="pallas" (the CLI's --accel pallas frame). K4's
    device time a launch is the mean over the K4 records of a CUDA-only
    trace of one replay of the chunk program (kernel_device_ms; of the
    eager loop if the trace shows no kernel of a graph's replay). The same
    frame then runs through the eager loop (a replay calls no wrapper)
    with a tally per launch: each launch's tally must count every one of
    its rays, which shows on the device that the launch ran, and the
    bounds are summed over these launches. The trace is not a count: it
    has dropped 1 to 5 of a frame's 384 K4 records, replayed or eager
    (perf_probe --k4-records), so it may show fewer records than
    launches, never more."""
    lib = m.build.load_library("cluster_cast")
    load = m.build.load_library
    tallies = []

    class Tallied:
        def cutrace_cluster_cast(self, *args):
            t = torch.zeros(m.pc.TALLY_COUNTS, dtype=torch.int64,
                            device="cuda")
            tallies.append((args[6], t))
            args = (*args[:11], m.fused._ptr(t), args[12])
            return lib.cutrace_cluster_cast(*args)

    m.render(prepared, bounces=5)  # warm-up: the capture
    torch.cuda.synchronize()
    traced_on = "program"
    total, n_rec = kernel_device_ms(lambda: m.render(prepared, bounces=5),
                                    "cluster_cast_kernel")
    if n_rec == 0:
        traced_on = "eager loop"
        total, n_rec = kernel_device_ms(
            lambda: m.render_eager(prepared, bounces=5),
            "cluster_cast_kernel")
    m.build.load_library = (lambda name: Tallied() if name == "cluster_cast"
                            else load(name))
    try:
        m.render_eager(prepared, bounces=5)
        torch.cuda.synchronize()
    finally:
        m.build.load_library = load
    n = len(tallies)
    short = [(r, int(t[0])) for r, t in tallies if int(t[0]) != r]
    if n == 0 or short:
        raise AssertionError(f"K4 in the pallas frame: {n} launches, "
                             f"{len(short)} of them cast fewer rays than "
                             f"they were given: {short[:4]}")
    if n_rec == 0 or n_rec > n:
        raise AssertionError(f"K4 in the pallas frame: the trace holds "
                             f"{n_rec} K4 records for {n} launches")
    bounds = [cast_bound(prepared.tables, r, t) for r, t in tallies]
    tally = sum(t for _, t in tallies)
    frame = {k: (sum(b[k][0] for b in bounds),
                 "operations" if sum(b[k][1] == "operations" for b in bounds)
                 * 2 >= n else "bytes") for k in ("bound", "bound_admitted")}
    rec["cast_frame"] = {"launches": n, "ms": total / n_rec * n,
                         "bound": frame, "rays": sum(r for r, _ in tallies),
                         "traced_on": traced_on, "traced_records": n_rec,
                         "traced_ms": total}
    phase("cast", f"K4 inside one --accel pallas bunny 1920x1080 b5 frame: "
          f"{n} launches of 65536 or 262144 rays "
          f"({rec['cast_frame']['rays']} rays, each cast on the device); "
          f"the {traced_on}'s trace holds {n_rec} of them, {total:.3f} ms "
          f"of device time summed ({total / n_rec:.4f} ms a launch, "
          f"{rec['cast_frame']['ms']:.3f} ms for the {n}); "
          f"{tally_text(tally)}; summed " + bound_text(frame)
          + f"; plain on one 65536-ray chunk "
          f"{rec['cast_chunk_plain_ms']:.1f} ms")


def phase_pallas(m, smi, rec, launches):
    """The CLI with --accel pallas on bunny 1920x1080 b5, then the pallas
    render at 480x270 b5 against the plain dense cast."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        m.reset()
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = m.cli.main([str(m.scenes / "bunny.json"), "--accel",
                             "pallas", "--out", tmp])
        launches["pallas"] = m.read()
        text = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"cli.main --accel pallas returned {rc}")
        for jpg in ("frame.jpg", "depth_map.jpg", "normal_map.jpg"):
            if os.path.getsize(os.path.join(tmp, jpg)) == 0:
                raise AssertionError(f"{jpg} is empty")
    counts = launches["pallas"]
    fused_runs = sum(counts[k] for k in ("fused_forward", "fused_forward_topo",
                                         "fused_forward_big",
                                         "fused_forward_big_topo"))
    if counts["cluster_cast"] < 1 or fused_runs:
        raise AssertionError(f"--accel pallas launches {counts}")
    render_line = next(ln for ln in text.splitlines()
                       if ln.startswith("Render time was"))
    rec["pallas_render_ms"] = float(render_line.split()[3])
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = 480, 270
    kern = m.render(m.prepare(sc, accel="pallas", device="cuda"), bounces=5)
    plain = m.render(m.prepare(sc, accel="clusters", device="cuda"),
                     bounces=5)
    stats = gate([x.cpu().numpy() for x in plain],
                 [x.cpu().numpy() for x in kern])
    phase("pallas", f"cli bunny.json --accel pallas 1920x1080 b5: "
          f"{render_line!r}; launches {counts}; 480x270 b5 vs the dense "
          f"cast: " + " ".join(f"{k}: off-edge {v[0]} edge {v[1]}/{v[2]}"
                               for k, v in stats.items())
          + f"; {time.perf_counter() - t0:.1f} s ({smi})")
    for k, (off, on, n_edges, _) in stats.items():
        if off or on > EDGE_BUDGET * max(n_edges, 1):
            raise AssertionError(f"pallas {k}: the culling cast's render "
                                 f"departs from the dense cast's")


def transparent_bunny(m, w, h):
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = w, h
    mesh = next(ob for ob in sc.objects if type(ob).__name__ == "Mesh")
    sc.materials[mesh.mat_idx].transparency = 0.5
    return sc


def phase_fallback(m, smi, rec):
    """Past the kernels' 63 nodes render takes the composable culling cast
    (K4); past the replay's rows the gradient's backward does (K1 forward,
    K4 casts). Both against the plain composable path."""
    t0 = time.perf_counter()
    sc = transparent_bunny(m, 160, 90)
    prepared = m.prepare(sc, accel="fused", device="cuda", bounces=6)
    soa = prepared.soa
    m.reset()
    kern = m.render(prepared, bounces=6)
    counts = m.read()
    if counts["cluster_cast"] < 1 or counts["fused_forward"]:
        raise AssertionError(f"b6 fallback launches {counts}")
    plain = m.render(soa, bounces=6)
    stats = gate([x.cpu().numpy() for x in plain],
                 [x.cpu().numpy() for x in kern])
    phase("fallback", f"transparent bunny 160x90 b6 (127 nodes, "
          f"{soa.shadow_steps} march steps): launches {counts}; vs brute "
          f"force: " + " ".join(f"{k}: off-edge {v[0]} edge {v[1]}/{v[2]}"
                                for k, v in stats.items()))
    for k, (off, on, n_edges, _) in stats.items():
        if off or on > EDGE_BUDGET * max(n_edges, 1):
            raise AssertionError(f"fallback {k}: departs from brute force")

    rows = m.rp.replay_rows(soa, 5)
    if m.fused.replay_supported(soa, prepared.accel, 5) or rows <= 512:
        raise AssertionError(f"{rows} rows: not past the replay's budget")
    with torch.no_grad():
        c0, _, _ = m.tgrad.render_image_flat(soa, 5, 1e-3, prepared.accel)
    target = 0.9 * c0
    params = {k: v.detach().clone().requires_grad_()
              for k, v in m.tgrad.extract_params(soa).items()}
    m.reset()
    loss = m.tgrad.render_loss(params, soa, target, 5, 1e-3, prepared.accel)
    loss.backward()
    torch.cuda.synchronize()
    counts = m.read()
    if (counts["fused_forward"] < 1 or counts["cluster_cast"] < 1
            or counts["fused_forward_topo"] or counts["replay_vjp"]):
        raise AssertionError(f"composable backward launches {counts}")
    want = {k: torch.zeros_like(v) for k, v in params.items()}
    n = soa.width * soa.height
    idx = torch.arange(n, device="cuda")
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    for s in range(0, n, FALLBACK_PLAIN_CHUNK):
        s2 = m.tgrad.with_params(soa, leaves)
        sl = idx[s:s + FALLBACK_PLAIN_CHUNK]
        o, d = m.camera_rays(s2, sl % soa.width, sl // soa.width)
        c, _, _ = m.render_rays(s2, o, d, 5, 1e-3)
        part = ((c - target[s:s + FALLBACK_PLAIN_CHUNK]) ** 2).sum() / (3 * n)
        grads = torch.autograd.grad(part, list(leaves.values()),
                                    allow_unused=True)
        for k, g in zip(leaves, grads):
            if g is not None:
                want[k] += g
    worst = 0.0
    for k, p in params.items():
        a = p.grad.double().cpu().numpy()
        b = want[k].double().cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"fallback grad[{k}] not finite")
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
        ok = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_RTOL * scale)
        if not ok.all():
            raise AssertionError(
                f"fallback grad[{k}]: {(~ok).sum()}/{a.size} mismatch, max "
                f"|diff| {np.abs(a - b).max():.3e} at scale {scale:.3e}")
        worst = max(worst, float(np.abs(a - b).max() / scale))
    rec["fallback_grad_err"] = worst
    phase("fallback", f"transparent bunny 160x90 b5 ({rows} rows > 512): "
          f"composable backward, launches {counts}; 19 groups within "
          f"rtol {VJP_RTOL} of autograd of brute force, max relative error "
          f"{worst:.2e}; {time.perf_counter() - t0:.1f} s ({smi})")



def bits_equal(a, b):
    """Do two float32 tensors hold the same bits (NaN and inf included)?"""
    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def bits_differ(a, b):
    """Elements of two float32 tensors whose bits differ (every element if
    the shapes differ)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def params_differ(a, b):
    """Per key of two dicts of float32 tensors, the elements whose bits
    differ (all of a tensor that only one dict holds); equal keys left
    out."""
    out = {k: bits_differ(a[k], b[k]) if k in a and k in b
           else (a.get(k) if k in a else b[k]).numel()
           for k in set(a) | set(b)}
    return {k: v for k, v in out.items() if v}


def frames_differ(a, b):
    """Names of the buffers of two (color, depth, normal) frames whose bits
    differ, with the count of differing elements."""
    return [f"{name} ({n})" for name, x, y in zip(("color", "depth",
                                                   "normal"), a, b)
            if (n := bits_differ(x, y))]


def check_finite(label, frame):
    """A frame's color finite, its depth and normal free of NaN (a miss's
    depth is inf)."""
    color, depth, normal = frame
    if not (bool(torch.isfinite(color).all()) and not depth.isnan().any()
            and not normal.isnan().any()):
        raise AssertionError(f"{label}: the frame is not finite")


def first_program_call(m, prepared, bounces):
    """The first render of a scene on the card (a warm-up frame or chunk,
    the capture, then the replays): host ms, and the peak and the held
    memory above what was allocated before, MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    captures = m.renderer.CAPTURES
    t0 = time.perf_counter()
    m.render(prepared, bounces=bounces)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if m.renderer.CAPTURES != captures + 1:
        raise AssertionError("the first render did not capture one program")
    return {"first_call_ms": ms,
            "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20,
            "held_mb": (torch.cuda.memory_allocated() - base) / 2**20}


def program_case(m, label, prepared, bounces, eager=None):
    """render's program against render_eager on one frame: the launch
    counts of one frame each, every bit of color, depth and normal, and
    no host synchronization inside the replays (torch's sync debug mode
    set to "error" around them). The program is captured first if it is
    not yet. Returns (eager frame, counts)."""
    if eager is None:
        m.reset()
        eager = m.render_eager(prepared, bounces=bounces)
        torch.cuda.synchronize()
        want = m.read()
    else:
        eager, want = eager
    m.render(prepared, bounces=bounces)
    torch.cuda.synchronize()
    captures = m.renderer.CAPTURES
    m.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = m.render(prepared, bounces=bounces)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = m.read()
    if m.renderer.CAPTURES != captures:
        raise AssertionError(f"{label}: a second render captured again")
    bad = frames_differ(eager, got)
    if bad:
        raise AssertionError(f"{label}: the program's frame differs from "
                             f"the eager loop's in " + ", ".join(bad))
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} a program frame, "
                             f"{want} an eager one")
    return eager, {k: v for k, v in counts.items() if v}


def aliasing_case(m, label, prepared, bounces, value):
    """Keep a frame, change `value` (a tensor the program reads) in place,
    render again: the kept frame must not change, and the new one must
    equal the eager loop's for the changed scene (and differ from the
    kept one)."""
    kept = m.render(prepared, bounces=bounces)
    snap = [x.clone() for x in kept]
    value.add_(0.25)
    new = m.render(prepared, bounces=bounces)
    torch.cuda.synchronize()
    if frames_differ(kept, snap):
        raise AssertionError(f"{label}: a kept frame changed under the next "
                             f"render")
    bad = frames_differ(new, m.render_eager(prepared, bounces=bounces))
    if bad:
        raise AssertionError(f"{label}: after an in-place change the "
                             f"program differs from the eager loop in "
                             + ", ".join(bad))
    if not frames_differ(new, snap):
        raise AssertionError(f"{label}: the in-place change did not show")


def program_turns(m, prepared, bounces, eager_reps, program_reps):
    """CUDA-event ms of the eager loop and the program in turns eager,
    program, eager."""
    eager = lambda: m.render_eager(prepared, bounces=bounces)  # noqa: E731
    prog = lambda: m.render(prepared, bounces=bounces)  # noqa: E731
    return {"eager_ms": [cuda_ms(eager, eager_reps)],
            "program_ms": cuda_ms(prog, program_reps),
            "eager_ms_again": cuda_ms(eager, eager_reps)}


def phase_program(m, smi, rec):
    """The frame programs (render on the card) against the eager loop
    (render_eager) on the same card: seven frames bit for bit with equal
    launch counts, no host synchronization in the replays, a kept frame
    unchanged by an in-place scene change, and the 1080p frames' times,
    first-call time and memory."""
    t0 = time.perf_counter()
    out = {}
    sc = m.load_scene(m.scenes / "bunny.json")
    # bunny 1920x1080 b5 fused (K1)
    p = m.prepare(sc, accel="fused", device="cuda", bounces=5)
    fused_rec = first_program_call(m, p, 5)
    _, fused_rec["launches"] = program_case(m, "bunny 1080p fused", p, 5)
    fused_rec.update(program_turns(m, p, 5, 5, 5))
    aliasing_case(m, "bunny 1080p fused", p, 5, p.tables.ambient)
    out["fused_1080p"] = fused_rec
    del p
    # bunny 1920x1080 b5 pallas (K4 flat)
    p = m.prepare(sc, accel="pallas", device="cuda", bounces=5)
    pallas_rec = first_program_call(m, p, 5)
    m.reset()
    turns = {"eager_ms": []}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    eager = m.render_eager(p, bounces=5)
    end.record()
    end.synchronize()
    turns["eager_ms"].append(start.elapsed_time(end))
    want = m.read()
    _, pallas_rec["launches"] = program_case(m, "bunny 1080p pallas", p, 5,
                                             (eager, want))
    del eager
    # K4 casts a chunk: one nearest cast a tree level and one a march
    # step (all lights batched)
    soa = p.soa
    chunk = m.renderer.default_chunk(soa, 5, lights=False)
    n_chunks = -(-soa.width * soa.height // chunk)
    levels = 6 if (soa.any_reflective or soa.any_transparent) else 1
    expect = n_chunks * levels * (1 + (soa.shadow_steps if soa.n_lights
                                       else 0))
    if pallas_rec["launches"].get("cluster_cast") != expect:
        raise AssertionError(f"pallas frame: {pallas_rec['launches']} K4 "
                             f"launches, not {expect}")
    more = program_turns(m, p, 5, 1, 3)
    pallas_rec.update(eager_ms=turns["eager_ms"] + more["eager_ms"],
                      program_ms=more["program_ms"],
                      eager_ms_again=more["eager_ms_again"])
    out["pallas_1080p"] = pallas_rec
    del p
    # mirror and sphere_plane 1920x1080 b5 fused (K1)
    for name in ("mirror", "sphere_plane"):
        label = f"{name} 1080p fused"
        p = m.prepare(m.load_scene(m.scenes / f"{name}.json"),
                      accel="fused", device="cuda", bounces=5)
        eager, launched = program_case(m, label, p, 5)
        if launched != {"fused_forward": 1}:
            raise AssertionError(f"{label}: {launched}")
        check_finite(label, eager)
        aliasing_case(m, label, p, 5, p.tables.ambient)
        out[f"{name}_1080p_launches"] = launched
        del p, eager
    # the 16k subdivided bunny 480x270 b5 pallas (K4 tree, M > 32) and
    # fused (K3)
    sc16, _ = m.bigscene.subdivided_bunny(2, 480, 270)
    p = m.prepare(sc16, accel="pallas", device="cuda", bounces=5)
    if p.accel.order.shape[0] <= m.pc.FLAT_MAX_M:
        raise AssertionError("the 16k partition takes K4's flat instance")
    _, out["pallas_16k_launches"] = program_case(m, "16k pallas", p, 5)
    aliasing_case(m, "16k pallas", p, 5, p.soa.ambient)
    del p
    p = m.prepare(sc16, accel="fused", device="cuda", bounces=5)
    _, out["fused_16k_launches"] = program_case(m, "16k fused (K3)", p, 5)
    if out["fused_16k_launches"] != {"fused_forward_big": 1}:
        raise AssertionError(f"16k fused: {out['fused_16k_launches']}")
    del p
    # the transparent bunny 160x90 b6: 127 nodes, the composable fallback
    p = m.prepare(transparent_bunny(m, 160, 90), accel="fused",
                  device="cuda", bounces=6)
    _, out["fallback_launches"] = program_case(m, "transparent 160x90 b6",
                                               p, 6)
    del p
    rec["program"] = out
    phase("program", "bit-identical to the eager loop, equal launches, no "
          "sync in replays, kept frames unchanged: " + json.dumps(out)
          + f"; {time.perf_counter() - t0:.1f} s ({smi})")


def max_rel(losses, ref):
    """The largest relative difference of two fits' losses, step by
    step."""
    a = np.asarray(losses, np.float64)
    b = np.asarray(ref, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"losses {losses} against {ref}")
    return float((np.abs(a - b) / np.abs(b)).max())


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def timed_fit(m, *args, **kw):
    """(seconds, params, losses) of one fit (its losses fetched to the
    host at its end, so the seconds hold every step's work)."""
    t0 = time.perf_counter()
    params, losses = m.fit(*args, **kw)
    return time.perf_counter() - t0, params, losses


def forced_fit(m, label, soa, target, steps, lr, bounces, param_filter,
               accel, camera="raw"):
    """`steps` Adam steps (capturable, eps 1e-8, as fit builds it) of the
    step program and of the op-by-op step from the same state: before
    each call the op-by-op side's parameters and optimizer state are set
    to the program's. Every step's loss, gradients and updated parameters
    must be bit-equal: the forward and K2's exact sums are functions of
    their inputs, and both sides run the same arithmetic."""
    base = {k: v.detach().clone()
            for k, v in m.tgrad.extract_params(soa, camera=camera).items()}
    sides = []
    for program in (True, False):
        params = {k: v.clone() for k, v in base.items()}
        for k in param_filter:
            params[k].requires_grad_()
        opt = torch.optim.Adam([params[k] for k in param_filter], lr=lr,
                               eps=1e-8, capturable=True)
        step = m.train.make_train_step(opt, bounces,
                                       param_filter=param_filter,
                                       accel=accel, program=program)
        sides.append((params, opt, step))
    (p_prog, o_prog, prog), (p_eager, o_eager, eager) = sides
    for i in range(steps):
        with torch.no_grad():
            for k in param_filter:
                p_eager[k].copy_(p_prog[k])
            for a, b in zip(o_eager.param_groups[0]["params"],
                            o_prog.param_groups[0]["params"]):
                for name, v in o_prog.state[b].items():
                    o_eager.state[a][name].copy_(v)
        got = prog(p_prog, soa, target).item()
        want = eager(p_eager, soa, target).item()
        if got != want:
            raise AssertionError(f"{label} step {i}: loss {got!r} from the "
                                 f"same state as the op-by-op {want!r}")
        for what in ("grad", "data"):
            differ = params_differ(
                {k: getattr(p_prog[k], what) for k in param_filter},
                {k: getattr(p_eager[k], what) for k in param_filter})
            if differ:
                raise AssertionError(f"{label} step {i}: parameter {what} "
                                     f"differs from the same state's "
                                     f"op-by-op step: {differ}")


def step_fit_case(m, prepared, rec):
    """The train phase's fit (bunny 1920x1080 b5, mat_color perturbed by
    default_rng(7), lr 5e-2, 5 steps) through the step program against
    the op-by-op fit, wall seconds in turns op by op, program, op by op:
    one capture, K1 with codes and K2 five times each in
    both, every loss and the final parameters bit-equal, and a second
    op-by-op fit's too; the same 5 steps from the same state (forced_fit):
    gradients and parameters bit-equal step by step. Then a
    checkpoint saved between replays holds the live parameters, and a
    resumed fit continues from it: its first loss bit-equal to a forward
    at the saved parameters."""
    soa, accel = prepared.soa, prepared.accel
    target, start = fit_start(soa, accel, m.tgrad)
    kw = dict(lr=5e-2, bounces=5, param_filter=("mat_color",), accel=accel,
              device="cuda")
    out = {}
    captures = m.renderer.CAPTURES
    m.reset()
    eager_s, p_eager, l_eager = timed_fit(m, start, target, steps=5,
                                          program=False, **kw)
    want = nonzero(m.read())
    m.reset()
    out["program_s"], p_prog, l_prog = timed_fit(m, start, target, steps=5,
                                                 **kw)
    got = nonzero(m.read())
    again_s, _, l_again = timed_fit(m, start, target, steps=5, program=False,
                                    **kw)
    out["eager_s"] = [eager_s, again_s]
    if m.renderer.CAPTURES != captures + 1:
        raise AssertionError(f"fit: {m.renderer.CAPTURES - captures} "
                             f"captures, not 1 (the program's)")
    if not got == want == {"fused_forward_topo": 5, "replay_vjp": 5}:
        raise AssertionError(f"fit launches: program {got}, eager {want}")
    if not l_prog == l_eager == l_again:
        raise AssertionError(f"fit losses: program {l_prog}, op by op "
                             f"{l_eager} and {l_again}, not bit-equal")
    out["params_differ"] = params_differ(p_prog, p_eager)
    if out["params_differ"]:
        raise AssertionError(f"fit final parameters: program against op "
                             f"by op {out['params_differ']}")
    forced_fit(m, "bunny 1080p fit", start, target, 5, 5e-2, 5,
               ("mat_color",), accel)
    out["launches"] = got
    out["losses"] = {"program": l_prog, "eager": l_eager}
    with tempfile.TemporaryDirectory() as tmp:
        ck = dict(kw, checkpoint_dir=tmp, checkpoint_every=2)
        _, kept, first = timed_fit(m, start, target, steps=5, **ck)
        saved, _, _ = m.ckpt.restore_checkpoint(tmp, kept, step=4)
        _, _, more = timed_fit(m, start, target, steps=7, **ck)
        latest = m.ckpt.latest_step(tmp)
    if not all(torch.equal(saved[k], kept[k]) for k in kept):
        raise AssertionError("the checkpoint at step 4 is not the fit's "
                             "parameters")
    if latest != 6 or len(more) != 2 or not np.isfinite(more).all():
        raise AssertionError(f"resumed fit: losses {more}, newest "
                             f"checkpoint {latest}")
    with torch.no_grad():
        again = m.tgrad.render_loss(saved, start, target, 5, 1e-3,
                                    accel).item()
    if more[0] != again:
        raise AssertionError(f"resumed fit: first loss {more[0]!r}, a "
                             f"forward at the saved parameters {again!r}")
    out["resumed"] = more
    rec["fit"] = out


def step_program_case(m, label, prepared, expect, reps=3):
    """One training step over all 19 groups (perf_probe.grad_step, lr 0:
    every call at the same parameters) as the step program against the
    op-by-op step: the first three calls (eager; capture and replay;
    replay) by the host clock with the peak and held memory above what
    was allocated before, and the memory the card keeps reserved past
    what it reserved before, the caches emptied (the graph's pool and
    the optimizer's state); one replay with torch's sync debug mode
    "error" and the launch counts reset, equal to an op-by-op step's and
    to `expect` (a count, or None for at least one), its gradients
    bit-equal to the op-by-op step's; CUDA-event times in turns op by op,
    program, op by op."""
    prog, prog_params = m.probe.grad_step(prepared, program=True)
    eager, eager_params = m.probe.grad_step(prepared, program=False)
    out = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    captures = m.renderer.CAPTURES
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        prog()
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
    out["first_calls_ms"] = calls
    out["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    out["held_mb"] = (torch.cuda.memory_allocated() - base) / 2**20
    torch.cuda.empty_cache()  # what stays reserved is the graph's pool
    out["pool_mb"] = (torch.cuda.memory_reserved() - reserved) / 2**20
    eager()
    torch.cuda.synchronize()
    m.reset()
    eager()
    torch.cuda.synchronize()
    want = nonzero(m.read())
    m.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    got = nonzero(m.read())
    if m.renderer.CAPTURES != captures + 1:
        raise AssertionError(f"{label}: {m.renderer.CAPTURES - captures} "
                             f"captures, not 1")
    if got != want or set(got) != set(expect) or any(
            n is not None and got[k] != n for k, n in expect.items()):
        raise AssertionError(f"{label}: launches {got} a replayed step, "
                             f"{want} an op-by-op one, expected {expect}")
    out["launches"] = got
    missing = [k for k in prog_params if (prog_params[k].grad is None)
               != (eager_params[k].grad is None)]
    if missing:
        raise AssertionError(f"{label}: gradients present in one step "
                             f"only: {missing}")
    out["grads_differ"] = params_differ(
        *({k: p.grad for k, p in ps.items() if p.grad is not None}
          for ps in (prog_params, eager_params)))
    if out["grads_differ"]:
        raise AssertionError(f"{label}: the step program's gradients "
                             f"differ from the op-by-op step's: "
                             f"{out['grads_differ']}")
    out["eager_ms"] = cuda_ms(eager, reps)
    out["program_ms"] = cuda_ms(prog, reps)
    out["eager_ms_again"] = cuda_ms(eager, reps)
    phase("step-program", f"{label}: " + json.dumps(
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in out.items()}))
    return out


LOOK_AT_KEYS = ("cam_eye", "cam_target", "cam_up_hint", "cam_scales")


def example_fits(m):
    """examples/inverse_rendering.py's settings: sphere_plane 64x36, every
    material color from 0.5 back to the b2 render (150 steps, lr 5e-2),
    then the look-at camera (eye, target, up hint and scales) from a
    shaken eye back to the b1 render (50 steps, lr 4e-3): the two fits'
    (name, scene, target, fit arguments)."""
    sc = m.load_scene(m.scenes / "sphere_plane.json")
    sc.camera.width, sc.camera.height = 64, 36
    soa = m.scene_to_soa(sc, device="cuda")
    with torch.no_grad():
        target, _, _ = m.tgrad.render_image_flat(soa, 2, 1e-3)
        target_b1, _, _ = m.tgrad.render_image_flat(soa, 1, 1e-3)
    corrupt = dataclasses.replace(soa,
                                  mat_color=torch.full_like(soa.mat_color,
                                                            0.5))
    cam = m.camera.camera_to_look_at(soa)
    shaken = m.camera.apply_look_at(soa, dict(
        cam, cam_eye=cam["cam_eye"] + torch.tensor([0.08, -0.05, 0.06],
                                                   device="cuda")))
    return (("colors", corrupt, target,
             dict(steps=150, lr=5e-2, bounces=2, param_filter=("mat_color",),
                  camera="raw")),
            ("camera", shaken, target_b1,
             dict(steps=50, lr=4e-3, bounces=1, param_filter=LOOK_AT_KEYS,
                  camera="look_at")))


def example_run(m, fits, program):
    """The example's two fits from scratch, one after the other: (wall
    seconds, losses, final parameters keyed "fit.name")."""
    t0 = time.perf_counter()
    losses, params = [], {}
    for name, soa, target, kw in fits:
        p, part = m.fit(soa, target, device="cuda", program=program, **kw)
        losses += part
        params.update({f"{name}.{k}": v for k, v in p.items()})
    return time.perf_counter() - t0, losses, params


def step_example_case(m, rec):
    """The example's fits (example_fits): wall seconds of the two fits in
    turns op by op, program, op by op (two captures); every loss of the
    three bit-equal; every step from the same state (forced_fit). Then
    the example itself (inverse_rendering.run): both fits' losses fall."""
    fits = example_fits(m)
    captures = m.renderer.CAPTURES
    eager_s, eager, _ = example_run(m, fits, False)
    program_s, program, _ = example_run(m, fits, True)
    eager_again_s, eager_again, _ = example_run(m, fits, False)
    if m.renderer.CAPTURES != captures + 2:
        raise AssertionError(f"example: {m.renderer.CAPTURES - captures} "
                             f"captures, not 2")
    if not program == eager == eager_again:
        raise AssertionError(f"example: program and op-by-op losses not "
                             f"bit-equal (max relative "
                             f"{max_rel(program, eager):.2e}, op by op "
                             f"twice {max_rel(eager_again, eager):.2e})")
    for name, soa, target, kw in fits:
        forced_fit(m, f"example {name}", soa, target, accel=m.prepare(
            soa, accel="fused", bounces=kw["bounces"]).accel, **kw)
    # the example itself (inverse_rendering.run at its own settings: 150
    # color steps, then 250 eye steps): both fits' losses fall
    t0 = time.perf_counter()
    run = m.ir.run(device="cuda")
    run_s = time.perf_counter() - t0
    for name in ("losses", "camera_losses"):
        part = run[name]
        if not part[-1] < part[0]:
            raise AssertionError(f"example run {name}: {part[0]} to "
                                 f"{part[-1]}")
    rec["example"] = {"eager_s": [eager_s, eager_again_s],
                      "program_s": program_s,
                      "losses": [program[0], program[149], program[150],
                                 program[-1]],
                      "run_s": run_s,
                      "run_losses": [run["losses"][0], run["losses"][-1],
                                     run["camera_losses"][0],
                                     run["camera_losses"][-1]]}
    phase("step-program", "example (sphere_plane 64x36, 150 mat_color "
          "steps b2, then 50 look-at camera steps b1): " + json.dumps(
              rec["example"]))


def phase_step_program(m, main_prepared, smi, rec):
    """The step program (make_train_step / fit on the card: one CUDA
    graph a step over K1/K3 with codes and K2, or K1 and K4 under
    autograd) against the op-by-op step on the same card."""
    t0 = time.perf_counter()
    out = {}
    step_fit_case(m, main_prepared, out)
    phase("step-program", "bunny 1920x1080 b5 fit, 5 steps: " + json.dumps(
        {k: v for k, v in out["fit"].items() if k != "losses"})
        + " losses " + json.dumps(out["fit"]["losses"]))
    topo = {"fused_forward_topo": 1, "replay_vjp": 1}
    out["bunny_1080p"] = step_program_case(m, "bunny 1920x1080 b5",
                                           main_prepared, topo)
    sc = m.load_scene(m.scenes / "sphere_plane.json")
    p = m.prepare(sc, accel="fused", device="cuda", bounces=5)
    out["sphere_plane_1080p"] = step_program_case(
        m, "sphere_plane 1920x1080 b5", p, topo)
    p = m.prepare(transparent_bunny(m, 160, 90), accel="fused",
                  device="cuda", bounces=5)
    out["transparent_160x90"] = step_program_case(
        m, f"transparent bunny 160x90 b5 ({m.rp.replay_rows(p.soa, 5)} "
        f"rows: K1, composable backward through K4)", p,
        {"fused_forward": 1, "cluster_cast": None})
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = 480, 270
    p = m.prepare(sc, accel="pallas", device="cuda", bounces=5)
    out["pallas_480x270"] = step_program_case(
        m, "bunny 480x270 b5 pallas (K4 under autograd)", p,
        {"cluster_cast": None})
    del p
    p, label = big_prepared(m, 4, 960, 540)
    out["bunny_256k"] = step_program_case(
        m, label, p, {"fused_forward_big_topo": 1, "replay_vjp": 1})
    del p
    torch.cuda.empty_cache()
    step_example_case(m, out)
    rec["step_program"] = out
    phase("step-program", f"done in {time.perf_counter() - t0:.1f} s "
          f"({smi})")


def k2_repeat(m, prepared, seed):
    """K2 alone (vjp_tables) three times on the same codes and numpy-seeded
    cotangents: the elements of d_rays (d_o, d_d), d_tbl and d_misc (the
    light and ambient cotangents) whose bits differ from the first
    call's, summed over the later calls."""
    soa = prepared.soa
    o, d, _ = m.block_rays(soa)
    *_, codes = m.fused.fused_render_rays(soa, prepared.accel, o, d, 1e-3, 5,
                                          emit_topo=True,
                                          tables=prepared.tables)
    rng = np.random.default_rng(seed)
    r = o.shape[0]
    cot = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .cuda() for s in ((r, 3), (r,), (r, 3)))
    tables = [x.detach() for x in m.rv.backward_tables(soa)]
    outs = []
    for _ in range(3):
        outs.append(m.rv.vjp_tables(soa, *tables, o, d, codes, cot, 1e-3, 5))
        torch.cuda.synchronize()
    groups = {"d_tbl": (0,), "d_misc": (1, 2), "d_rays": (3, 4)}
    counts = {name: sum(bits_differ(out[i], outs[0][i]) for out in outs[1:]
                        for i in idx) for name, idx in groups.items()}
    inst = m.rv.vjp_instance(soa, 5)
    return {"instance": inst.sums, "differ": counts}


def grad_repeat(m, prepared):
    """The 19-group gradient (perf_probe.grad_step, lr 0: every call at the
    same parameters) called three times as the step program (eager,
    capture and replay, replay) and twice op by op: per group, the
    elements whose bits differ from the first call of the same kind,
    and between the first program and the first op-by-op call."""
    runs = {}
    for program, calls in ((True, 3), (False, 2)):
        step, params = m.probe.grad_step(prepared, program=program)
        runs[program] = []
        for _ in range(calls):
            step()
            torch.cuda.synchronize()
            runs[program].append({k: p.grad.clone() for k, p in
                                  params.items() if p.grad is not None})
        del step, params
    prog, eager = runs[True], runs[False]
    out = {"program": dict(sum((Counter(params_differ(g, prog[0]))
                                for g in prog[1:]), Counter())),
           "eager": params_differ(eager[1], eager[0]),
           "program_vs_eager": params_differ(prog[0], eager[0]),
           "groups": len(eager[0])}
    torch.cuda.empty_cache()
    return out


def resume_case(m):
    """A 10-step bunny 480x270 b5 fit (mat_color perturbed as fit_start
    does, light_color and ambient trained too, lr 5e-2) uninterrupted,
    against 5 steps, a checkpoint, and a fresh fit call resuming to step
    10: the elements of the final parameters and of the Adam state (as
    the step-9 checkpoints hold them) whose bits differ."""
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = 480, 270
    p = m.prepare(sc, accel="fused", device="cuda", bounces=5)
    target, start = fit_start(p.soa, p.accel, m.tgrad)
    kw = dict(lr=5e-2, bounces=5, accel=p.accel, device="cuda",
              param_filter=("mat_color", "light_color", "ambient"))
    like = {k: v.detach().clone() for k, v in
            m.tgrad.extract_params(start).items()}
    with tempfile.TemporaryDirectory() as one, \
            tempfile.TemporaryDirectory() as two:
        m.fit(start, target, steps=10, checkpoint_dir=one,
              checkpoint_every=100, **kw)
        m.fit(start, target, steps=5, checkpoint_dir=two,
              checkpoint_every=100, **kw)
        if m.ckpt.latest_step(two) != 4:
            raise AssertionError("the 5-step fit saved no step 4")
        _, resumed = m.fit(start, target, steps=10, checkpoint_dir=two,
                           checkpoint_every=100, **kw)
        if len(resumed) != 5:
            raise AssertionError(f"the resumed fit ran {len(resumed)} steps")
        a, sa, step_a = m.ckpt.restore_checkpoint(one, like)
        b, sb, step_b = m.ckpt.restore_checkpoint(two, like)
    if step_a != step_b or step_a != 9:
        raise AssertionError(f"checkpoints at steps {step_a}, {step_b}")
    differ = params_differ(a, b)
    for i, state in sa["state"].items():
        for name, v in state.items():
            n = bits_differ(v.float(), sb["state"][i][name].float())
            if n:
                differ[f"adam.{i}.{name}"] = n
    return {"differ": differ, "resumed_losses": resumed}


def exact_sum_case(m, n_el=17102, n=1 << 20, seed=400):
    """K2's sums alone (replay_vjp.exact_sum: the kernel's split, integer
    atomics and rounding) on `n` numpy-seeded terms into bunny's n_el
    table elements, half of them into one row of 17 (a wall's), over 11
    decades, with NaN, infinities, a float-overflowing pair and terms
    under the grid in a few elements: against exact_sum_plain, and against
    itself with the terms shuffled. Returns the counts of elements whose
    bits differ."""
    rng = np.random.default_rng(seed)
    idx = np.where(rng.random(n) < 0.5, rng.integers(0, 17, n),
                   rng.integers(0, n_el, n)).astype(np.int32)
    vals = (rng.normal(size=n) * 10.0 ** rng.uniform(-8, 3, n)).astype(
        np.float32)
    special = [np.inf, -np.inf, np.nan, 3e38, 3e38, 2.0 ** -65, 1e-45]
    idx[:7] = [n_el - 1, n_el - 2, n_el - 3, n_el - 4, n_el - 4, n_el - 5,
               n_el - 6]
    vals[:7] = special
    perm = rng.permutation(n)
    index, values = torch.from_numpy(idx), torch.from_numpy(vals)
    got = m.rv.exact_sum(index.cuda(), values.cuda(), n_el)
    again = m.rv.exact_sum(index[perm].cuda(), values[perm].cuda(), n_el)
    want = m.rv.exact_sum_plain(index, values, n_el)
    torch.cuda.synchronize()
    return {"terms": n, "elements": n_el,
            "plain_differ": bits_differ(got.cpu(), want),
            "shuffled_differ": bits_differ(again, got)}


def phase_determinism(m, main_prepared, smi, rec):
    """Same inputs, same bits: K2's sums alone against their plain version
    (exact_sum_case), K2 three times (bunny and sphere_plane 1920x1080 b5,
    the 256k bunny 960x540 b5), the 19-group gradient twice op by op and
    three times as a step program, and between the two (those three, the
    transparent bunny 160x90 b5 through K4, bunny 480x270 b5 "pallas"),
    the example's fits twice from scratch as programs, and a fit resumed
    from a checkpoint against an uninterrupted one. Every count of
    differing elements is printed before the gate, which wants them all
    zero."""
    t0 = time.perf_counter()
    out = {"exact_sum": exact_sum_case(m), "k2": {}, "grad": {}}
    phase("determinism", "K2's sums alone (exact_sum) against their plain "
          "version and shuffled: " + json.dumps(out["exact_sum"]))
    sp = m.prepare(m.load_scene(m.scenes / "sphere_plane.json"),
                   accel="fused", device="cuda", bounces=5)
    big, big_label = big_prepared(m, 4, 960, 540)
    fused_cases = (("bunny 1920x1080 b5", main_prepared),
                   ("sphere_plane 1920x1080 b5", sp), (big_label, big))
    for seed, (label, prepared) in enumerate(fused_cases):
        out["k2"][label] = k2_repeat(m, prepared, 300 + seed)
        phase("determinism", f"K2 x3 {label}: " + json.dumps(
            out["k2"][label]))
        torch.cuda.empty_cache()
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = 480, 270
    steps = fused_cases + (
        ("transparent bunny 160x90 b5 (K4 backward)",
         m.prepare(transparent_bunny(m, 160, 90), accel="fused",
                   device="cuda", bounces=5)),
        ("bunny 480x270 b5 pallas",
         m.prepare(sc, accel="pallas", device="cuda", bounces=5)))
    for label, prepared in steps:
        out["grad"][label] = grad_repeat(m, prepared)
        phase("determinism", f"gradient {label}: " + json.dumps(
            out["grad"][label]))
    del sp, big, steps
    torch.cuda.empty_cache()
    fits = example_fits(m)
    (_, la, pa), (_, lb, pb) = (example_run(m, fits, True) for _ in "ab")
    out["example"] = {"losses_differ": int(sum(
        x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))),
        "params_differ": params_differ(pa, pb)}
    phase("determinism", "example fit twice as programs: "
          + json.dumps(out["example"]))
    out["resume"] = resume_case(m)
    phase("determinism", "bunny 480x270 b5 fit resumed at step 5 against "
          "10 uninterrupted steps: " + json.dumps(out["resume"]))
    rec["determinism"] = out
    bad = [f"exact_sum: {out['exact_sum']}"] if (
        out["exact_sum"]["plain_differ"]
        or out["exact_sum"]["shuffled_differ"]) else []
    bad += [f"K2 {k}: {v['differ']}" for k, v in out["k2"].items()
           if any(v["differ"].values())]
    bad += [f"gradient {k} {kind}: {v[kind]}"
            for k, v in out["grad"].items()
            for kind in ("program", "eager", "program_vs_eager") if v[kind]]
    if out["example"]["losses_differ"] or out["example"]["params_differ"]:
        bad.append(f"example fit: {out['example']}")
    if out["resume"]["differ"]:
        bad.append(f"resumed fit: {out['resume']['differ']}")
    if bad:
        raise AssertionError("not bit-reproducible: " + "; ".join(bad))
    phase("determinism", f"every case bit-equal; "
          f"{time.perf_counter() - t0:.1f} s ({smi})")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def image_diff(a, b):
    """(pixels that differ in any bit, max |difference| over finite
    values) of two image tuples; +inf equals +inf."""
    n, worst = 0, 0.0
    for x, y in zip(a, b):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        same = (x == y) | (np.isinf(x) & np.isinf(y))
        n += int((~same.reshape(x.shape[0], x.shape[1], -1).all(-1)).sum())
        both = np.isfinite(x) & np.isfinite(y)
        worst = max(worst, float(np.abs(np.where(both, x - y, 0.0)).max()))
    return n, worst


def grad_gate(label, got, want):
    """The vjp gate (isclose rtol VJP_RTOL, atol VJP_RTOL * scale) on every
    gradient group; returns the largest relative error."""
    worst = 0.0
    for k, b in want.items():
        a = got[k].double().cpu().numpy()
        b = b.double().cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"{label} grad[{k}] not finite")
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
        ok = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_RTOL * scale)
        if not ok.all():
            raise AssertionError(
                f"{label} grad[{k}]: {(~ok).sum()}/{a.size} mismatch, max "
                f"|diff| {np.abs(a - b).max():.3e} at scale {scale:.3e}")
        worst = max(worst, float(np.abs(a - b).max() / scale))
    return worst


def fit_start(soa, accel, tgrad):
    """The train phase's fit inputs: the target render and the scene with
    mat_color perturbed by seeded noise."""
    with torch.no_grad():
        target, _, _ = tgrad.render_image_flat(soa, 5, 1e-3, accel)
    rng = np.random.default_rng(7)
    color = soa.mat_color.cpu().numpy()
    start = np.clip(color + rng.normal(0.0, 0.15, color.shape), 0.0,
                    1.0).astype(np.float32)
    return target, dataclasses.replace(
        soa, mat_color=torch.from_numpy(start).to(soa.device))


def multi_rank(rank, port, out_dir, root):
    """One of the multi phase's two ranks on cuda:0 over gloo (NCCL takes
    one rank a device). Writes its results to out_dir/rank{rank}.json and
    raises on a failed gate."""
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from cutrace_tpu_torch import bigscene, load_scene
    from cutrace_tpu_torch.diff import grad as tgrad
    from cutrace_tpu_torch.ops import fused, pallas_cast as pc
    from cutrace_tpu_torch.ops import replay_vjp as rv
    from cutrace_tpu_torch.parallel import multihost
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.parallel import train
    from cutrace_tpu_torch.render import renderer
    from cutrace_tpu_torch.render.renderer import prepare, render

    dev = torch.device("cuda:0")
    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo",
                         device=dev)
    res = {"backend": dist.get_backend()}
    scenes = pathlib.Path(root) / "scenes"
    mesh21 = sh.make_mesh(2, 1, device=dev)
    mesh12 = sh.make_mesh(1, 2, device=dev)

    def sharded(label, prepared, mesh, count):
        ref = render(prepared, bounces=5)
        ready = sh.prepare_sharded(prepared, mesh)
        captures = renderer.CAPTURES
        reset_launches(fused, rv, pc)
        out = sh.render_sharded(ready, mesh, bounces=5)
        torch.cuda.synchronize()
        counts = read_launches(fused, rv, pc)
        if counts[count] < 1:
            raise AssertionError(f"rank {rank} {label}: {count} not "
                                 f"launched: {counts}")
        if renderer.CAPTURES != captures:
            raise AssertionError(f"rank {rank} {label}: render_sharded "
                                 f"over gloo captured a program")
        res[label] = {"launches": counts, "diff": image_diff(ref, out)}
        return ref, out, ready

    def bunny(w, h, accel):
        sc = load_scene(scenes / "bunny.json")
        sc.camera.width, sc.camera.height = w, h
        return prepare(sc, accel=accel, device=dev, bounces=5)

    main = bunny(1920, 1080, "fused")
    _, _, ready = sharded("k1", main, mesh21, "fused_forward")
    dist.barrier()
    captures = renderer.CAPTURES
    res["k1"]["ms"] = cuda_ms(
        lambda: sh.render_sharded(ready, mesh21, bounces=5), 3)
    if renderer.CAPTURES != captures:
        raise AssertionError(f"rank {rank}: render_sharded over gloo "
                             f"captured a program")
    res["k1"]["render_ms"] = cuda_ms(lambda: render(main, bounces=5), 3)
    sc, _ = bigscene.subdivided_bunny(2, 480, 270)
    sharded("k3", prepare(sc, accel="fused", device=dev, bounces=5),
            mesh21, "fused_forward_big")
    culled = bunny(480, 270, "pallas")
    ref, out, _ = sharded("k4", culled, mesh12, "cluster_cast")
    res["k4"]["gate"] = gate([x.cpu().numpy() for x in ref],
                             [x.cpu().numpy() for x in out])

    small = bunny(480, 270, "fused")
    soa, accel = small.soa, small.accel
    with torch.no_grad():
        c0, _, _ = tgrad.render_image_flat(soa, 5, 1e-3, accel)
    target = 0.9 * c0
    _, want = tgrad.grad_render_loss(soa, target, 5, 1e-3, accel)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(soa).items()}
    reset_launches(fused, rv, pc)
    loss = train.sharded_loss(params, soa, mesh21, target, 5, 1e-3, accel)
    loss.backward()
    train._all_reduce_grads(params, loss, mesh21)
    torch.cuda.synchronize()
    counts = read_launches(fused, rv, pc)
    if counts["fused_forward_topo"] < 1 or counts["replay_vjp"] < 1:
        raise AssertionError(f"rank {rank} grad: launches {counts}")
    res["grad"] = {"launches": counts, "err": grad_gate(
        f"rank {rank} (2, 1)", {k: p.grad for k, p in params.items()},
        want)}
    # gloo's collectives go through the host: fit stays op by op
    captures = renderer.CAPTURES
    reset_launches(fused, rv, pc)
    _, losses = train.fit(soa, target, steps=2, bounces=5,
                          param_filter=("mat_color",), accel=accel,
                          mesh=mesh21)
    counts = read_launches(fused, rv, pc)
    if renderer.CAPTURES != captures or counts["replay_vjp"] != 2:
        raise AssertionError(f"rank {rank} (2, 1) gloo fit: "
                             f"{renderer.CAPTURES - captures} captures, "
                             f"launches {counts}")
    res["gloo_fit"] = {"losses": losses, "launches": counts}

    # (1, 2): each rank differentiates through K4 over its own triangle
    # shard; the triangle gradients gathered back, held to one device's
    soa, accel = culled.soa, culled.accel
    _, want = tgrad.grad_render_loss(soa, target, 5, 1e-3, accel)
    local = sh.shard_scene(soa, mesh12)
    accel_local = sh.shard_accel(soa, mesh12, accel.kind)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(local).items()}
    reset_launches(fused, rv, pc)
    loss = train.sharded_loss(params, local, mesh12, target, 5, 1e-3,
                              accel_local)
    loss.backward()
    train._all_reduce_grads(params, loss, mesh12)
    torch.cuda.synchronize()
    counts = read_launches(fused, rv, pc)
    if counts["cluster_cast"] < 1:
        raise AssertionError(f"rank {rank} (1, 2) grad: launches {counts}")
    n_tris = soa.tri_p1.shape[0]
    got = {k: sh.unshard_rows(p.grad, mesh12, n_tris)
           if k in sh._TRI_FIELDS else p.grad for k, p in params.items()}
    res["grad12"] = {"launches": counts, "err": grad_gate(
        f"rank {rank} (1, 2) pallas", got, want)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_program_case(m, sh, prepared, mesh, rec):
    """render_sharded's program at world 1 over NCCL (bunny 1080p b5,
    "fused": K1 and the image's all-gather in one graph) against
    render_sharded_eager and render: one capture for the ShardedScene,
    every bit equal, equal launches (K1 once), no sync in a replay; then
    CUDA-event times in turns eager, program, program, eager."""
    ready = sh.prepare_sharded(prepared, mesh)
    ref = m.render(prepared, bounces=5)
    m.reset()
    eager = sh.render_sharded_eager(ready, mesh, bounces=5)
    torch.cuda.synchronize()
    want = m.read()
    captures = m.renderer.CAPTURES
    t0 = time.perf_counter()
    first = sh.render_sharded(ready, mesh, bounces=5)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    m.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sh.render_sharded(ready, mesh, bounces=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = m.read()
    if m.renderer.CAPTURES != captures + 1:
        raise AssertionError(f"render_sharded over NCCL: "
                             f"{m.renderer.CAPTURES - captures} captures, "
                             f"not one")
    for label, other in (("render_sharded_eager", eager), ("render", ref),
                         ("the first program frame", first)):
        bad = frames_differ(got, other)
        if bad:
            raise AssertionError(f"render_sharded's program differs from "
                                 f"{label} in " + ", ".join(bad))
    if counts != want or counts["fused_forward"] != 1:
        raise AssertionError(f"render_sharded launches {counts} a program "
                             f"frame, {want} an eager one")
    prog = lambda: sh.render_sharded(ready, mesh, bounces=5)  # noqa: E731
    eag = lambda: sh.render_sharded_eager(  # noqa: E731
        ready, mesh, bounces=5)
    turns = {"eager_ms": [cuda_ms(eag, 5)], "program_ms": [cuda_ms(prog, 5)]}
    turns["program_ms"].append(cuda_ms(prog, 5))
    turns["eager_ms"].append(cuda_ms(eag, 5))
    rec["multi_world1_ms"] = float(np.mean(turns["program_ms"]))
    rec["multi_render_ms"] = cuda_ms(lambda: m.render(prepared, bounces=5),
                                     5)
    rec["multi_program"] = {"launches": nonzero(counts), "turns": turns,
                            "first_call_ms": first_ms}
    return {"eager": nonzero(want), "first_call_ms": first_ms}


def prims_chunk_case(m, sh, mesh, rec):
    """The prims route's composable chunk as a captured program at world
    1 over NCCL: bunny 480x270 b5 "pallas", its chunks rendered by
    renderer._chunk_rows with sharded_tri_candidates over the mesh's one
    shard (K4, the candidates' two all-gathers over the prims group and
    the combine inside each chunk's graph), against the same chunks op by
    op: one capture, every bit equal, equal launches with K4 among them,
    no sync in a replay; the frame's buffers against render's, printed."""
    sc = m.load_scene(m.scenes / "bunny.json")
    sc.camera.width, sc.camera.height = 480, 270
    pallas = m.prepare(sc, accel="pallas", device=mesh.device, bounces=5)
    ready = sh.prepare_sharded(pallas, mesh)
    soa = ready.soa

    def parts(scene):
        return scene.soa, sh.sharded_tri_candidates(
            scene.mesh, scene.soa.tri_p1.shape[0], scene.accel,
            scene.tables)

    chunk = m.renderer.default_chunk(soa, 5, lights=False)
    n_pad = -(-soa.width * soa.height // chunk) * chunk
    bo = m.renderer.block_order_tensors(soa.width, soa.height, n_pad,
                                        mesh.device)

    def rows(program):
        with torch.no_grad():
            return m.renderer._chunk_rows(ready, parts, bo.pxy, 5, 1e-3,
                                          chunk, program)

    m.reset()
    eager = rows(False)
    torch.cuda.synchronize()
    want = m.read()
    captures = m.renderer.CAPTURES
    rows(True)
    torch.cuda.synchronize()
    m.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rows(True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = m.read()
    if m.renderer.CAPTURES != captures + 1:
        raise AssertionError("the prims chunk did not run through one "
                             "captured program")
    if not bits_equal(got, eager):
        raise AssertionError("the prims chunk program differs from its "
                             "eager loop")
    if counts != want or counts["cluster_cast"] < 1:
        raise AssertionError(f"prims chunk launches {counts} as programs, "
                             f"{want} op by op")
    frame = m.renderer._unpack(soa, bo.inverse, got)
    differ = frames_differ(frame, m.render(pallas, bounces=5))
    rec["multi_prims"] = {
        "launches": nonzero(counts), "chunks": n_pad // chunk,
        "chunk": chunk, "differ_render": differ,
        "eager_ms": cuda_ms(lambda: rows(False), 1),
        "program_ms": cuda_ms(lambda: rows(True), 3)}
    return dict(rec["multi_prims"], differ_render=len(differ))


def phase_multi(m, main_prepared, root, smi, rec, launches):
    """(a) one NCCL rank in this process; (b) two gloo ranks spawned on
    the same card (multi_rank), joined within MULTI_DEADLINE_S."""
    import torch.distributed as dist

    from cutrace_tpu_torch.parallel import multihost
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.parallel.train import fit

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    multihost.initialize(f"localhost:{free_port()}", 1, 0, device=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        mesh = sh.make_mesh(1, 1, device=dev)
        sharded = sharded_program_case(m, sh, main_prepared, mesh, rec)
        prims = prims_chunk_case(m, sh, mesh, rec)
        soa, accel = main_prepared.soa, main_prepared.accel
        target, start = fit_start(soa, accel, m.tgrad)
        kw = dict(steps=3, lr=5e-2, bounces=5, param_filter=("mat_color",),
                  accel=accel, device=dev)
        m.reset()
        captures = m.renderer.CAPTURES
        mesh_params, losses = fit(start, target, mesh=mesh, **kw)
        torch.cuda.synchronize()
        launches["multi_fit"] = m.read()
        if m.renderer.CAPTURES != captures + 1:
            raise AssertionError("fit(mesh=...) over NCCL did not train "
                                 "through one step program")
        again_params, again = fit(start, target, mesh=mesh, **kw)
        rec["multi_fit_differ"] = {
            "losses": sum(x != y for x, y in zip(losses, again)),
            "params": params_differ(mesh_params, again_params)}
        if rec["multi_fit_differ"]["losses"] or rec[
                "multi_fit_differ"]["params"]:
            raise AssertionError(f"fit(mesh=...) twice: losses {losses} "
                                 f"and {again}, parameters differ "
                                 f"{rec['multi_fit_differ']['params']}")
        _, ref_losses = fit(start, target, **kw)
        if (launches["multi_fit"]["fused_forward_topo"] < 3
                or launches["multi_fit"]["replay_vjp"] < 3):
            raise AssertionError(f"fit(mesh=...) launches "
                                 f"{launches['multi_fit']}")
        rel = np.abs(np.subtract(losses, ref_losses)) / np.abs(ref_losses)
        if not (np.isfinite(losses).all() and (rel <= FIT_RTOL).all()):
            raise AssertionError(f"fit(mesh=...) losses {losses} against "
                                 f"{ref_losses}")
    finally:
        m.renderer.drop_programs()
        dist.destroy_process_group()
    launches["multi"] = rec["multi_program"]["launches"]
    phase("multi", f"(a) NCCL, world 1, mesh (1, 1): render_sharded bunny "
          f"1920x1080 b5 through one captured program, bit-identical to "
          f"render and to render_sharded_eager, launches "
          f"{launches['multi']} a frame (eager {sharded['eager']}), no sync "
          f"in a replay; first call {sharded['first_call_ms']:.1f} ms; the "
          f"prims route's chunk program (sharded_tri_candidates, world 1) "
          f"over bunny 480x270 b5 pallas, {prims['chunks']} chunks of "
          f"{prims['chunk']}: bit-identical to its eager loop, launches "
          f"{prims['launches']}, {prims['differ_render']} buffers differ "
          f"from render; fit(mesh=...) 3 steps through the step "
          f"program (its gradient sum captured: an all-gather and the "
          f"adds in rank order): losses "
          + " ".join(f"{x:.8f}" for x in losses) + " against "
          + " ".join(f"{x:.8f}" for x in ref_losses)
          + f" of the one-device program fit (max relative "
          f"{rel.max():.2e}, gate {FIT_RTOL}), launches "
          f"{launches['multi_fit']}; run twice, losses and parameters "
          f"bit-equal")

    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=multi_rank, args=(r, port, tmp,
                                                      str(root)))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MULTI_DEADLINE_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise AssertionError(f"multi ranks {hung} still running after "
                                 f"{MULTI_DEADLINE_S} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"multi ranks exited with {codes}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        for key, label in (("k1", "(2, 1) bunny 1920x1080 b5, K1"),
                           ("k3", "(2, 1) bunny/16k 480x270 b5, K3")):
            n_diff, worst = res[key]["diff"]
            phase("multi", f"(b) rank {r}, {res['backend']} (collectives "
                  f"of CUDA tensors staged through the host): {label}: "
                  f"{n_diff} pixels differ from render (max {worst:.3e}); "
                  f"launches {res[key]['launches']}")
            if n_diff:
                raise AssertionError(f"rank {r} {label}: not bit-identical")
        stats = res["k4"]["gate"]
        phase("multi", f"(b) rank {r}: (1, 2) bunny 480x270 b5 pallas, K4 "
              f"on each shard: vs the one-rank pallas render "
              + " ".join(f"{k}: off-edge {v[0]} edge {v[1]}/{v[2]}"
                         for k, v in stats.items())
              + f" ({res['k4']['diff'][0]} pixels not bit-identical); "
              f"launches {res['k4']['launches']}")
        for k, (off, on, n_edges, _) in stats.items():
            if off or on > EDGE_BUDGET * max(n_edges, 1):
                raise AssertionError(f"rank {r} (1, 2) pallas {k}: departs "
                                     f"from the one-rank render")
        phase("multi", f"(b) rank {r}: (2, 1) gradient step bunny 480x270 "
              f"b5: 19 groups within rtol {VJP_RTOL} of the one-device "
              f"step, max relative error {res['grad']['err']:.2e}; "
              f"launches {res['grad']['launches']}")
        phase("multi", f"(b) rank {r}: (2, 1) fit bunny 480x270 b5, 2 "
              f"steps over gloo, op by op (nothing captured): losses "
              f"{res['gloo_fit']['losses']}, launches "
              f"{res['gloo_fit']['launches']}")
        phase("multi", f"(b) rank {r}: (1, 2) gradient step bunny 480x270 "
              f"b5 pallas, K4 on each shard: 19 groups (triangle rows "
              f"gathered) within rtol {VJP_RTOL} of the one-device culling-"
              f"cast step, max relative error {res['grad12']['err']:.2e}; "
              f"launches {res['grad12']['launches']}")
    rec["multi_world2_ms"] = max(res["k1"]["ms"] for res in ranks)
    turns = rec["multi_program"]["turns"]
    rec["multi_world2_render_ms"] = max(res["k1"]["render_ms"]
                                        for res in ranks)
    rec["multi_grad_err"] = max(res[k]["err"] for res in ranks
                                for k in ("grad", "grad12"))
    phase("multi", f"bunny 1920x1080 b5 frame by CUDA events (mean of 5; "
          f"3 on each of the two ranks, the larger): render "
          f"{rec['multi_render_ms']:.3f} ms, render_sharded world 1 (NCCL) "
          f"program {turns['program_ms'][0]:.3f} / "
          f"{turns['program_ms'][1]:.3f} ms, render_sharded_eager "
          f"{turns['eager_ms'][0]:.3f} / {turns['eager_ms'][1]:.3f} ms "
          f"(turns eager, program, program, eager); the prims chunk "
          f"frame program {rec['multi_prims']['program_ms']:.3f} ms, eager "
          f"{rec['multi_prims']['eager_ms']:.3f} ms; two gloo ranks sharing the "
          f"card: render_sharded {rec['multi_world2_ms']:.3f} ms, render "
          f"{rec['multi_world2_render_ms']:.3f} ms; overhead, not scaling "
          f"({smi})")
    phase("multi", f"done in {time.perf_counter() - t0:.1f} s")


def nccl_algo_fits(root, n_cards):
    """`multihost --steps 3` on bunny 1920x1080 b5 over every card, (n, 1),
    under NCCL_ALGO=allreduce:ring, then allreduce:tree (NCCL_ALGOS),
    through cutrace_tpu_torch.compare_fits: each run's line and the
    summary of what differs between the two."""
    from cutrace_tpu_torch import compare_fits
    from cutrace_tpu_torch.scaling import DEADLINE_S

    with tempfile.TemporaryDirectory() as tmp:
        lines, summary = compare_fits.compare(
            [root], ["smoke"], list(NCCL_ALGOS.values()), n_cards,
            pathlib.Path(tmp), [str(root / "scenes" / MAIN_SCENE),
                                "--steps", "3", "--reps", "3"], DEADLINE_S)
    zero = {"losses": 0, "params": 0}
    for line in lines:
        if (not line["step_program"] or line["pixels_differ"]
                or line["fit_differ"] != {"program": zero, "eager": zero}
                or line["params_sha256"] != line["fit_params_sha256"]):
            raise AssertionError(f"multihost under NCCL_ALGO={line['algo']}"
                                 f": {line['fit_differ']}, step program "
                                 f"{line['step_program']}, "
                                 f"{line['pixels_differ']} pixels differ, "
                                 f"digests {line['params_sha256']} "
                                 f"{line['fit_params_sha256']}")
    ring, tree = lines
    differ = summary["smoke"]["differ"]
    if (ring["fit_params_sha256"] != tree["fit_params_sha256"]
            or ring["fit_losses"] != tree["fit_losses"]
            or any(d["losses"] or d["params"] for d in differ.values())):
        raise AssertionError(f"the fit differs between NCCL_ALGO settings "
                             f"{list(NCCL_ALGOS.values())}: {differ}; "
                             f"{ring['fit_losses']} "
                             f"{ring['fit_params_sha256']} against "
                             f"{tree['fit_losses']} "
                             f"{tree['fit_params_sha256']}")
    return lines, summary


def phase_scaling(root, smi, rec):
    """The scaling sweep over every card present, and with two or more
    the NCCL_ALGO fits (the docstring's phase 21)."""
    from cutrace_tpu_torch.scaling import mesh_sizes
    from cutrace_tpu_torch.utils.subprocs import failure_text, run_tree
    k1 = "fused.LAUNCHES"  # multihost's key of K1's shared-memory instance

    torch.cuda.empty_cache()  # the card's memory for the subprocesses
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    tag = "scaling/bunny_1920x1080_b5"
    rc, out, err = run_tree(
        [sys.executable, "-m", "cutrace_tpu_torch.scaling", "--width",
         "1920", "--height", "1080", "--bounces", "5", "--reps", "10"],
        root, timeout=SCALING_DEADLINE_S)
    print(out, end="", flush=True)
    if rc != 0:
        print(failure_text(err), file=sys.stderr, flush=True)
        raise AssertionError(f"the scaling sweep exited {rc}")
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    want = [f"{tag}/devices{n}" for n in mesh_sizes(n_cards)]
    if [r["metric"] for r in rows] != want + [f"{tag}/efficiency"]:
        raise AssertionError(f"the sweep printed "
                             f"{[r['metric'] for r in rows]}")
    for r in rows:
        if r["correct"] is not True or r["backend"] != "cuda":
            raise AssertionError(f"{r['metric']}: correct {r['correct']}, "
                                 f"backend {r['backend']}")
    for r in rows[:-1]:
        # the timed program frames ran K1 once a rank a frame, nothing else
        if (r["pixels_differ"] or not all(
                isinstance(r[k], float) for k in ("work_invariance",
                                                  "balance"))
                or r["sample_launches"] != [{k1: r["n"]}] * r["devices"]
                or r["frame_launches"]["program"] != {k1: 1}):
            raise AssertionError(f"{r['metric']}: {r['pixels_differ']} "
                                 f"pixels differ, work_invariance "
                                 f"{r['work_invariance']}, balance "
                                 f"{r['balance']}, launches over the "
                                 f"{r['n']} sampled frames "
                                 f"{r['sample_launches']}, in a program "
                                 f"frame {r['frame_launches']['program']}")
        phase("scaling", f"{r['metric']}: {r['value']:.1f} Mcasts/s "
              f"(median frame {r['median']:.3f} ms of {r['n']}, the "
              f"slowest rank's), efficiency {r['efficiency_vs_linear']:.3f}"
              f", work_invariance {r['work_invariance']:.4f}, balance "
              f"{r['balance']:.4f}, 0 pixels differ; each rank's sampled "
              f"frames launched K1 {r['n']} times and nothing else ({smi})")
    rec["scaling"] = {"lines": rows}
    if n_cards >= 2:
        lines, summary = nccl_algo_fits(root, n_cards)
        rec["scaling"]["nccl_algo_fits"] = {
            "runs": [{k: line[k] for k in ("algo", "mesh", "fit_losses",
                                           "fit_params_sha256",
                                           "fit_differ")}
                     for line in lines], "summary": summary["smoke"]}
        steps = summary["smoke"]["replayed_step_ms"]
        phase("scaling", f"multihost --steps 3 at ({n_cards}, 1) under "
              f"NCCL_ALGO={NCCL_ALGOS['Ring']} and {NCCL_ALGOS['Tree']} "
              f"(compare_fits): the same losses {lines[0]['fit_losses']} "
              f"and parameters (sha256 "
              f"{lines[0]['fit_params_sha256'][:16]}...), two program "
              f"fits and two op-by-op fits bit-equal in each; replayed "
              f"step medians {steps} ms ({smi})")
    else:
        phase("scaling", "one card: the NCCL_ALGO fits need two or more")
    phase("scaling", f"done in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--skip", nargs="*", default=[], choices=PHASES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from cutrace_tpu_torch import bigscene, cli, load_scene, perf_probe
    from cutrace_tpu_torch import inverse_rendering
    from cutrace_tpu_torch.diff import camera as tcamera
    from cutrace_tpu_torch.diff import checkpoint as ckpt
    from cutrace_tpu_torch.diff import grad as tgrad
    from cutrace_tpu_torch.ops import _build, bvh, fused
    from cutrace_tpu_torch.ops import intersect
    from cutrace_tpu_torch.ops import pallas_cast as pc
    from cutrace_tpu_torch.ops import replay as rp
    from cutrace_tpu_torch.ops import replay_vjp as rv
    from cutrace_tpu_torch.parallel import train
    from cutrace_tpu_torch.parallel.train import fit
    from cutrace_tpu_torch.render import renderer, shading
    from cutrace_tpu_torch.render.renderer import (to_image, block_rays,
                                                   camera_rays, prepare,
                                                   render, render_eager,
                                                   render_rays)
    from cutrace_tpu_torch.scene.soa import scene_to_soa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    scenes = root / "scenes"
    skip = set(args.skip)
    rec = {}
    m = types.SimpleNamespace(
        bigscene=bigscene, cli=cli, load_scene=load_scene, tgrad=tgrad,
        fused=fused, pc=pc, rp=rp, rv=rv, bvh=bvh, I=intersect, sh=shading,
        to_image=to_image, build=_build,
        block_rays=block_rays, camera_rays=camera_rays, prepare=prepare,
        render=render, render_eager=render_eager, renderer=renderer,
        render_rays=render_rays, scenes=scenes, fit=fit, ckpt=ckpt,
        probe=perf_probe, camera=tcamera, scene_to_soa=scene_to_soa,
        train=train, ir=inverse_rendering,
        reset=lambda: reset_launches(fused, rv, pc),
        read=lambda: read_launches(fused, rv, pc))
    t_start = time.perf_counter()

    # 1. probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    phase("probe", f"python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    phase("probe", "nvcc " + nvcc.stdout.strip().splitlines()[-1])
    print(smi, flush=True)

    # 2. build: every kernel, one nvcc each, started together
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    for name in libs:
        _build.load_library(name)
    phase("build", " ".join(str(p.relative_to(root)) for p in libs.values())
          + f" built in {time.perf_counter() - t0:.1f} s")

    # 3. parity: kernel vs plain version, same rays on the same card
    max_err = 0.0
    launches = {}
    prepared_small = {}
    for name, w, h, bounces in PARITY:
        scene = load_scene(scenes / name)
        scene.camera.width, scene.camera.height = w, h
        prepared = prepare(scene, accel="fused", device=dev, bounces=bounces)
        prepared_small[name] = (prepared, bounces)
        if "parity" in skip:
            continue
        soa, accel = prepared.soa, prepared.accel
        o, d, inverse = block_rays(soa)
        kern = fused.fused_render_rays(soa, accel, o, d, 1e-3, bounces,
                                       tables=prepared.tables)
        torch.cuda.synchronize()
        plain = fused.fused_render_rays_plain(soa, accel, o, d, 1e-3, bounces)
        max_err = max(max_err, check_parity(
            f"{name} {w}x{h} b{bounces} M={accel.order.shape[0]}", soa,
            inverse, kern, plain, to_image))
    if "parity" not in skip:
        phase_k1_global(m, rec, launches)

    # 4. timing at the main path's shapes; the first calls are also held
    # to the parity gate at that size
    scene = load_scene(scenes / MAIN_SCENE)
    main_prepared = prepare(scene, accel="fused", device=dev, bounces=5)
    soa, accel = main_prepared.soa, main_prepared.accel
    o, d, inverse = block_rays(soa)
    if "timing" not in skip:
        kernel_fn = lambda: fused.fused_render_rays(  # noqa: E731
            soa, accel, o, d, 1e-3, 5, tables=main_prepared.tables)
        plain_fn = lambda: fused.fused_render_rays_plain(  # noqa: E731
            soa, accel, o, d, 1e-3, 5)
        kern = kernel_fn()
        torch.cuda.synchronize()
        plain = plain_fn()
        max_err = max(max_err, check_parity(
            f"{MAIN_SCENE} {soa.width}x{soa.height} b5 "
            f"M={accel.order.shape[0]}", soa, inverse, kern, plain, to_image))
        del kern, plain
        plain_ms = [cuda_ms(plain_fn, 1)]
        rec["kernel_ms"] = cuda_ms(kernel_fn, 10)
        plain_ms.append(cuda_ms(plain_fn, 1))
        rec["plain_ms"] = min(plain_ms)
        tally = tally_of(lambda t: fused._fused_forward_cuda(
            soa, main_prepared.tables, o, d, 1e-3, 5, tally=t))
        near = tally_of(lambda t: fused._fused_forward_cuda(
            dataclasses.replace(soa, n_lights=0), main_prepared.tables, o,
            d, 1e-3, 5, tally=t))
        rec["bound"] = forward_bound(soa, accel, main_prepared.tables,
                                     o.shape[0], tally, 0)
        shared = fused.k1_instance(soa, main_prepared.tables)
        rec["k1_resources"] = _build.kernel_attributes("fused_forward",
                                                       shared)
        if shared != fused._K1_SHARED:
            raise AssertionError("bunny 1080p does not take K1's "
                                 "shared-memory instance")
        # what the shared-memory staging bought: K1's global-memory
        # instance on the same rays (the size rule overridden for this
        # timing alone), in turns with the shared-memory one
        index = dev.index or 0
        limit = fused.shared_limit(dev)
        fused._SHARED_LIMIT[index] = 0
        try:
            glob = kernel_fn()
            rec["kernel_global_ms"] = cuda_ms(kernel_fn, 10)
        finally:
            fused._SHARED_LIMIT[index] = limit
        rec["kernel_ms_again"] = cuda_ms(kernel_fn, 10)
        diff = max(float(torch.nan_to_num(
            (a - b).abs(), nan=0.0).max()) for a, b in zip(glob, kernel_fn()))
        phase("timing", f"{MAIN_SCENE} {soa.width}x{soa.height} b5 M="
              f"{accel.order.shape[0]}: K1 shared-memory instance "
              f"{rec['kernel_ms']:.3f} / {rec['kernel_ms_again']:.3f} ms, "
              f"global-memory instance {rec['kernel_global_ms']:.3f} ms "
              f"(max |difference| {diff:.2e}), plain {plain_ms[0]:.3f} / "
              f"{plain_ms[1]:.3f} ms; {tally_text(tally)}; "
              f"{root_split_text(tally, near)}; "
              + bound_text(rec["bound"]) + "; "
              + resources_text(rec["k1_resources"]) + f" ({smi})")

    # 5. the main path through the CLI
    if "main" not in skip:
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(fused, rv, pc)
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = cli.main([str(scenes / MAIN_SCENE), "--out", tmp])
            launches["cli"] = read_launches(fused, rv, pc)
            text = buf.getvalue()
            print(text, end="")
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            for jpg in ("frame.jpg", "depth_map.jpg", "normal_map.jpg"):
                size = os.path.getsize(os.path.join(tmp, jpg))
                if size == 0:
                    raise AssertionError(f"{jpg} is empty")
        if launches["cli"]["fused_forward"] < 1:
            raise AssertionError("the CLI run never launched the fused "
                                 "kernel")
        render_line = next(ln for ln in text.splitlines()
                           if ln.startswith("Render time was"))
        color, depth, normal = render(main_prepared, bounces=5)
        if tuple(color.shape) != (1080, 1920, 3) or not bool(
                torch.isfinite(color).all()):
            raise AssertionError("bunny 1080p color is not a finite (1080, "
                                 "1920, 3) image")
        phase("main", f"cli bunny.json 1920x1080 b5: {render_line!r}; "
              f"launches {launches['cli']}; hit pixels "
              f"{int(torch.isfinite(depth).sum())}")

    # 6. topo and 7. vjp: the parity scenes, then bunny at 1080p
    topo_err = vjp_err = 0.0
    cases = [(f"{n} {p.soa.width}x{p.soa.height} b{b}", p, b, None)
             for n, (p, b) in prepared_small.items()]
    cases.append((f"{MAIN_SCENE} 1920x1080 b5", main_prepared, 5, rec))
    for seed, (label, prepared, bounces, r) in enumerate(cases):
        if "topo" in skip and "vjp" in skip:
            break
        codes, o_, d_, err = run_topo(label, prepared, bounces, fused, rp, r)
        topo_err = max(topo_err, err)
        if "vjp" not in skip:
            vjp_err = max(vjp_err, run_vjp(label, prepared.soa, o_, d_, codes,
                                           bounces, rp, rv, seed, r))
        del codes, o_, d_

    # 8. grad: the gradient step over all 19 groups at 1080p
    if "grad" not in skip:
        step, params = grad_step_fn(main_prepared, 5, tgrad)
        reset_launches(fused, rv, pc)
        loss = step().detach()
        torch.cuda.synchronize()
        launches["grad"] = read_launches(fused, rv, pc)
        if len(params) != 19:
            raise AssertionError(f"{len(params)} parameter groups, not 19")
        for k, p in params.items():
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"grad[{k}] missing or not finite")
        if (launches["grad"]["fused_forward_topo"] < 1
                or launches["grad"]["replay_vjp"] < 1):
            raise AssertionError(f"the gradient step missed a kernel: "
                                 f"{launches['grad']}")
        rec["step_ms"] = cuda_ms(step, 3)
        parts = grad_parts(main_prepared, 5, fused, rv, tgrad)
        rec["parts"] = parts
        phase("grad", f"{MAIN_SCENE} 1920x1080 b5: loss {loss.item():.6f}, "
              f"19 groups finite, launches {launches['grad']}; "
              f"{rec['step_ms'] / 1e3:.4f} s/step (mean of 3 after a "
              f"warm-up); parts ms " + json.dumps(
                  {k: round(v, 3) for k, v in parts.items()}) + f" ({smi})")
        del step, params
        sp = load_scene(scenes / "sphere_plane.json")
        sp_prepared = prepare(sp, accel="fused", device=dev, bounces=5)
        sp_step, sp_params = grad_step_fn(sp_prepared, 5, tgrad)
        sp_step()
        torch.cuda.synchronize()
        for k, p in sp_params.items():
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"sphere_plane grad[{k}] not finite")
        rec["sp_step_ms"] = cuda_ms(sp_step, 3)
        rec["sp_parts"] = grad_parts(sp_prepared, 5, fused, rv, tgrad)
        phase("grad", f"sphere_plane.json 1920x1080 b5 (63 nodes, "
              f"{rp.replay_rows(sp_prepared.soa, 5)} topo rows): "
              f"{rec['sp_step_ms'] / 1e3:.4f} s/step (mean of 3 after a "
              f"warm-up); parts ms " + json.dumps(
                  {k: round(v, 3) for k, v in rec["sp_parts"].items()})
              + f" ({smi})")
        del sp_step, sp_params, sp_prepared

    # 9. train: fit from a perturbed mat_color, then resume
    if "train" not in skip:
        with torch.no_grad():
            target, _, _ = tgrad.render_image_flat(soa, 5, 1e-3, accel)
        rng = np.random.default_rng(7)
        color = soa.mat_color.cpu().numpy()
        start = np.clip(color + rng.normal(0.0, 0.15, color.shape), 0.0,
                        1.0).astype(np.float32)
        start_soa = dataclasses.replace(
            soa, mat_color=torch.from_numpy(start).to(dev))
        kw = dict(lr=5e-2, bounces=5, param_filter=("mat_color",),
                  checkpoint_every=2, accel=accel, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(fused, rv, pc)
            t0 = time.perf_counter()
            params, losses = fit(start_soa, target, steps=5,
                                 checkpoint_dir=tmp, **kw)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches["train"] = read_launches(fused, rv, pc)
            if len(losses) != 5 or not np.isfinite(losses).all():
                raise AssertionError(f"fit losses {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"fit loss did not fall: {losses}")
            if ckpt.latest_step(tmp) != 4:
                raise AssertionError("fit saved no checkpoint at step 4")
            _, more = fit(start_soa, target, steps=7, checkpoint_dir=tmp,
                          **kw)
            if len(more) != 2 or not np.isfinite(more).all():
                raise AssertionError(f"resumed fit losses {more}")
            if not more[0] < losses[0]:
                raise AssertionError(f"resumed fit did not continue: {more}")
            if ckpt.latest_step(tmp) != 6:
                raise AssertionError("resumed fit saved no step 6")
        if (launches["train"]["fused_forward_topo"] < 5
                or launches["train"]["replay_vjp"] < 5):
            raise AssertionError(f"fit missed a kernel: {launches['train']}")
        phase("train", f"{MAIN_SCENE} 1920x1080 b5 fit mat_color 5 steps in "
              f"{fit_s:.2f} s: losses " + " ".join(f"{x:.6f}" for x in losses)
              + f"; resumed at step 5: " + " ".join(f"{x:.6f}" for x in more)
              + f"; launches {launches['train']}")

    # 10.-17. big scenes through K3, the culling cast through K4
    big = {}
    if "big-parity" not in skip:
        t0 = time.perf_counter()
        big = phase_big_parity(m, rec)
        phase("big-parity", f"done in {time.perf_counter() - t0:.1f} s")
        if "big-topo" not in skip:
            t0 = time.perf_counter()
            phase_big_topo_vjp(m, big, skip, rec)
            phase("big-topo", f"done in {time.perf_counter() - t0:.1f} s")
    if "big-frame" not in skip:
        phase_big_frame(m, smi, rec, launches)
    if "big-grad" not in skip:
        prepared, _ = big_prepared(m, 4, 960, 540)
        phase_big_grad(m, prepared, smi, rec, launches)
        del prepared
        torch.cuda.empty_cache()
    if "cast" not in skip:
        p256 = next((p for p in big.values() if p.accel.order.shape[0]
                     == 1024), None) or big_prepared(m, 4, 160, 90)[0]
        phase_cast(m, p256, smi, rec)
        del p256
    big.clear()
    if "pallas" not in skip:
        phase_pallas(m, smi, rec, launches)
    if "fallback" not in skip:
        phase_fallback(m, smi, rec)
    if "program" not in skip:
        phase_program(m, smi, rec)
    if "step-program" not in skip:
        phase_step_program(m, main_prepared, smi, rec)
    if "determinism" not in skip:
        phase_determinism(m, main_prepared, smi, rec)
    if "multi" not in skip:
        phase_multi(m, main_prepared, root, smi, rec, launches)
    if "scaling" not in skip:
        phase_scaling(root, smi, rec)
    phase("result", f"phases done in {time.perf_counter() - t_start:.1f} s")

    if skip:
        phase("result", f"phases skipped ({' '.join(sorted(skip))}): no "
              f"result line")
        return 0
    fused_src = "cutrace_tpu_torch/ops/csrc/fused_forward.cu"

    def entry(name, source, replaces, n, err, ms, plain, bounds, **extra):
        """One kernel of the result line: the work-based bound and the one
        from admitted visits (the same for K2, whose bound reads no
        tally)."""
        if not isinstance(bounds, dict):
            bounds = {"bound": bounds, "bound_admitted": bounds}
        # its launches in one replayed step of each step-program case
        in_steps = {case: r["launches"][name]
                    for case, r in rec["step_program"].items()
                    if case != "fit" and name in r.get("launches", {})}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain,
                "bound_ms": bounds["bound"][0],
                "bound_by": bounds["bound"][1],
                "bound_ms_admitted": bounds["bound_admitted"][0],
                "bound_by_admitted": bounds["bound_admitted"][1],
                "library_ms": None, "step_program_launches": in_steps,
                "sharded_program_launches": {
                    case: r["launches"][name]
                    for case, r in (("world1_fused_1080p",
                                     rec["multi_program"]),
                                    ("world1_prims_chunks_480x270",
                                     rec["multi_prims"]))
                    if name in r["launches"]},
                **extra}

    frame = rec["cast_frame"]
    kernels = [
        entry("fused_forward", fused_src, "cutrace_tpu/ops/fused.py:1734",
              launches["cli"]["fused_forward"], max_err, rec["kernel_ms"],
              rec["plain_ms"], rec["bound"],
              instance="K1, shared memory", resources=rec["k1_resources"],
              global_instance_ms=rec["kernel_global_ms"]),
        entry("fused_forward_topo", fused_src,
              "cutrace_tpu/ops/fused.py:1734",
              launches["train"]["fused_forward_topo"], topo_err,
              rec["topo_ms"], rec["topo_plain_ms"], rec["topo_bound"],
              instance="K1, shared memory", resources=rec["k1_resources"]),
        entry("fused_forward_global", fused_src,
              "cutrace_tpu/ops/fused.py:1734",
              launches["k1_global"]["fused_forward_global"], rec["k1g_err"],
              rec["k1g_ms"], rec["k1g_plain_ms"], rec["k1g_bound"],
              instance="K1, global memory", shape=rec["k1g_shape"],
              resources=rec["k1g_resources"]),
        entry("replay_vjp", "cutrace_tpu_torch/ops/csrc/replay_vjp.cu",
              "cutrace_tpu/ops/replay_vjp.py:204",
              launches["train"]["replay_vjp"], vjp_err, rec["vjp_ms"],
              rec["vjp_plain_ms"], rec["vjp_bound"],
              shape="bunny 1920x1080 b5; ms: the library call alone",
              wrapper_ms=rec["vjp_wrapper_ms"],
              instance=rec["vjp_instance"], resources=rec["vjp_resources"],
              at_256k={k: rec["big_topo"][k] for k in (
                  "vjp_ms", "vjp_wrapper_ms", "vjp_plain_ms", "vjp_bound",
                  "vjp_instance", "vjp_resources")}),
        entry("fused_forward_big", fused_src, "cutrace_tpu/ops/fused.py:445",
              launches["big_frame"]["fused_forward_big"], rec["big_err"],
              rec["big_ms"], rec["big_plain_ms"], rec["big_bound"],
              instance="K3, ordered tree walk", shape=rec["big_shape"],
              resources=rec["big_resources"]),
        entry("fused_forward_big_topo", fused_src,
              "cutrace_tpu/ops/fused.py:445",
              launches["big_grad"]["fused_forward_big_topo"],
              rec["big_topo_err"], rec["big_topo"]["topo_ms"],
              rec["big_topo"]["topo_plain_ms"], rec["big_topo"]["topo_bound"],
              instance="K3, ordered tree walk", shape=rec["big_shape"],
              resources=rec["big_resources"]),
        entry("cluster_cast", "cutrace_tpu_torch/ops/csrc/cluster_cast.cu",
              "cutrace_tpu/ops/pallas_cast.py:81",
              launches["pallas"]["cluster_cast"], rec["cast_err"],
              frame["ms"] / frame["launches"], rec["cast_chunk_plain_ms"],
              {k: (v[0] / frame["launches"], v[1])
               for k, v in frame["bound"].items()},
              shape="one launch of an --accel pallas bunny 1920x1080 b5 "
                    "frame (65536 or 262144 rays), M=16 C=64; ms: the "
                    "mean device time (torch.profiler) of the K4 "
                    "records in a trace of the replayed frame",
              frame_ms=frame["ms"],
              frame_launches=frame["launches"],
              frame_traced_on=frame["traced_on"],
              frame_traced_records=frame["traced_records"],
              frame_traced_ms=frame["traced_ms"],
              instance="flat (M <= 32; tree past it)",
              resources=rec["cast_resources"],
              primary_1080p={"ms": rec["cast_ms"],
                             "plain_ms": rec["cast_plain_ms"],
                             "bound_ms": rec["cast_bound"]["bound"][0],
                             "bound_ms_admitted":
                                 rec["cast_bound"]["bound_admitted"][0]},
              tree_256k={"rays": CAST_RANDOM_RAYS,
                         "ms": rec["cast_tree"]["ms"],
                         "bound_ms": rec["cast_tree"]["bound"]["bound"][0],
                         "bound_by": rec["cast_tree"]["bound"]["bound"][1],
                         "bound_ms_admitted":
                             rec["cast_tree"]["bound"]["bound_admitted"][0]}),
    ]
    print(smi, flush=True)
    print(json.dumps({
        "kernels": kernels, "grad_step_s": rec["step_ms"] / 1e3,
        "grad_step_parts_ms": rec["parts"],
        "sphere_plane_grad_step_s": rec["sp_step_ms"] / 1e3,
        "sphere_plane_grad_step_parts_ms": rec["sp_parts"],
        "big_grad_step_s": rec["big_step_ms"] / 1e3,
        "big_grad_step_parts_ms": rec["big_parts"],
        "replay_vjp_256k": {k: rec["big_topo"][k] for k in (
            "vjp_ms", "vjp_wrapper_ms", "vjp_plain_ms", "vjp_bound")},
        "bigscene": rec["bigscene"],
        "pallas_render_ms": rec["pallas_render_ms"],
        "program": rec["program"],
        "step_program": rec["step_program"],
        "multi": {"render_ms": rec["multi_render_ms"],
                  "sharded_world1_nccl_ms": rec["multi_world1_ms"],
                  "sharded_world1_program": rec["multi_program"],
                  "prims_chunk_world1": rec["multi_prims"],
                  "sharded_world2_gloo_ms": rec["multi_world2_ms"],
                  "render_beside_world2_ms": rec["multi_world2_render_ms"],
                  "grad_err": rec["multi_grad_err"],
                  "launches": {k: launches[k]
                               for k in ("multi", "multi_fit")}},
        "scaling": rec["scaling"],
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
