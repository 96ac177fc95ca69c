"""A closed loop of fit steps on one device: the program's
make_train_step over every parameter group of the prepared scene, with
capturable Adam (the mix's `lr`, eps 1e-8) updating only the mix's
`train` groups, against a target image, each step synchronised on the
device before the next is issued.

The target is the reference's float32 frame of the run's scene with the
mix's `perturb` groups moved by the seed (inputs.perturbation), so the fit
converges and nothing drifts over a long window. Set-up builds the step
once and drives it through its first three steps (eager, captured,
replayed); the same step object then runs the window. Those three steps'
losses, the gradients Adam got at the first (its first moment over 1 -
beta1) and each group's change after the third are compared with the
reference's three Adam steps from the same start and target."""

from __future__ import annotations

import time

import torch

from portbench import check, harness, inputs, roofline, trace
from portbench.reference import frame as rf
from portbench.reference.tracer import Counts, Tracer
from portbench.window import Window

FIRST_STEPS = 3


def make_target(ctx, data):
    """The reference's float32 frame of the run's scene with the mix's
    `perturb` groups moved (inputs.perturbation): (H·W, 3), scanline
    order, on the device."""
    tracer = Tracer(data, ctx.device, dtype=torch.float32)
    moved = tracer.params()
    for k, v in inputs.perturbation(ctx.mix, ctx.seed, data).items():
        moved[k] = torch.as_tensor(v, device=ctx.device)
    everything = torch.arange(data.width * data.height, device=ctx.device)
    return rf.render(tracer, moved, everything, ctx.cfg["bounces"],
                     ctx.block)[0]


def run(ctx: harness.Context) -> dict:
    from cutrace_tpu_torch.diff.grad import extract_params
    from cutrace_tpu_torch.parallel.train import make_train_step
    from cutrace_tpu_torch.render.renderer import drop_programs, prepare

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    bounces, groups, lr = cfg["bounces"], list(mix["train"]), mix["lr"]
    data = inputs.reference_scene(cfg, mix, ctx.seed)
    n = data.width * data.height
    t = time.perf_counter()
    target = make_target(ctx, data)
    harness.free(dev)
    target_s = time.perf_counter() - t

    scene = inputs.program_scene(cfg, mix, ctx.seed)
    harness.reset_peak(dev)
    t = time.perf_counter()
    prepared = prepare(scene, accel=cfg["accel"], device=dev,
                       bounces=bounces)
    harness.sync(dev)
    prepare_s = time.perf_counter() - t
    soa = prepared.soa
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(soa).items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8,
                           capturable=dev.type == "cuda")
    step = make_train_step(opt, bounces, param_filter=tuple(groups),
                           accel=prepared.accel)
    start = {k: params[k].detach().clone() for k in groups}

    def request():
        loss = step(params, soa, target)
        harness.sync(dev)
        return loss

    t = time.perf_counter()
    losses = [request()]
    beta1 = opt.param_groups[0]["betas"][0]
    # a group the optimizer holds no state for got no gradient
    grads = {k: (opt.state[params[k]]["exp_avg"] / (1 - beta1)).cpu()
             if "exp_avg" in opt.state[params[k]]
             else torch.zeros(params[k].shape) for k in groups}
    losses += [request() for _ in range(FIRST_STEPS - 1)]
    prog = {"losses": [float(x) for x in losses], "grads": grads,
            "change": {k: (params[k].detach() - start[k]).cpu()
                       for k in groups}}
    first_s = time.perf_counter() - t
    setup_s = time.perf_counter() - ctx.t0
    win = Window(ctx.window_seconds, ctx.seed)
    events = None
    if ctx.trace:
        _, events = trace.traced(lambda: win.run(request))
    else:
        win.run(request)
    peak = harness.peak_bytes(dev)
    win.kept = None
    del step, opt, params, prepared, soa, start
    drop_programs()
    harness.free(dev)

    t = time.perf_counter()
    tracer = Tracer(data, dev)
    base = tracer.params()
    r_losses, r_grads, r_change = rf.fit_steps(
        tracer, base, target, bounces, ctx.block, groups, lr, FIRST_STEPS)
    ref = {"losses": r_losses,
           "grads": {k: v.cpu() for k, v in r_grads.items()},
           "change": {k: v.cpu() for k, v in r_change.items()}}
    out = {"e2e": {"step_ms": win.mean_ms(), "step_p95_ms": win.p95_ms(),
                   "setup_s": setup_s},
           "attempted": len(win.latencies), "failed": 0,
           "memory_peak_bytes": peak,
           "numbers": check.fit_numbers(prog, ref),
           "detail": {"losses": [prog["losses"], r_losses],
                      "grads": check.group_gaps(prog["grads"], ref["grads"],
                                                groups),
                      "change": check.group_gaps(prog["change"],
                                                 ref["change"], groups)},
           "check_s": time.perf_counter() - t,
           "setup_parts": {"target_s": target_s, "prepare_s": prepare_s,
                           "first_steps_s": first_s}}
    if events is not None:
        counts = Counts()
        sample = harness.sample_pixels(n, ctx.reference_pixels("count_pixels"),
                                       ctx.seed, 3, dev)
        rf.render(tracer, base, sample, bounces, ctx.block, counts)
        sizes = harness.scene_sizes(data)
        tables = roofline.table_bytes(**sizes)
        scale = n / sample.numel()
        summary = trace.summarize(events)
        summary.update(
            kind="train", requests=len(win.latencies), prepare_s=prepare_s,
            bounds={"forward": roofline.forward_bound_s(
                        counts, scale, n, tables, sizes["n_planes"],
                        sizes["n_spheres"]),
                    "backward": roofline.backward_bound_s(
                        counts, scale, n, tables, sizes["n_lights"])})
        out["summary"] = summary
    return out
