"""Mix kind ``train``: a closed loop of the program's Adam iteration
(``train.train_step``) at batch 1, the views popped from a seeded shuffle of
the training views as 3DGS pops them, the iteration counter from the mix's
``first_iteration`` on (learning-rate schedule, SH degree), no density
control.

Set-up makes the scene, the views and their targets from the seed, sizes
the record capacities as the trainer would, and drives the first
``checked_steps`` iterations through ``train_step`` itself, keeping what
the check compares: each step's loss, the first gradient's norm per group
(from Adam's first moment after one step, which started at zero) and the
change of each group after those steps. It then warms up to
``warmup_steps`` and hands the same objects to the window. The check
follows those steps with the plain reference from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import scene
from port_bench.reference import train as ref_train
from port_bench.reference.render import FP32, camera_dict
from port_bench.trace import span

BETA1 = 0.9


class ViewOrder:
    """3DGS's view order: a shuffled list popped from its end, shuffled
    anew when empty."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.stack = n, np.random.default_rng(seed), []

    def next(self) -> int:
        if not self.stack:
            self.stack = list(range(self.n))
            self.rng.shuffle(self.stack)
        return self.stack.pop()


def _inputs(ctx):
    cfg = ctx.cfg
    s_scene, s_cam, s_tgt, s_order = scene.seeds(ctx.seed, 4)
    cams = scene.train_cameras(cfg, s_cam)
    return s_scene, s_tgt, s_order, cams


def setup(ctx):
    from port_bench import program
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    s_scene, s_tgt, s_order, cams = _inputs(ctx)
    params = program.params(scene.gaussians(cfg, s_scene, dev),
                            cfg["sh_degree"])
    ctx.mark("scene")
    batch = program.camera_batch(cams, scene.targets(cfg, s_tgt, dev,
                                                     len(cams)), dev)
    ctx.mark("targets")
    order = ViewOrder(len(cams), s_order)
    first = [order.next() for _ in range(mix["warmup_steps"])]
    probe = first + [order.next() for _ in range(mix["probe_views"])]
    order = ViewOrder(len(cams), s_order)          # the same order anew
    rcfg = program.raster_config(
        params, batch.take(probe), mix["capacity_headroom"])
    ctx.mark("capacity probe")
    opt = program.optimization(mix["optimization"])
    opt_state = program.init_adam(params)
    opt_state.step = mix["first_iteration"] - 1
    st = dict(params=params, batch=batch, order=order, rcfg=rcfg, opt=opt,
              opt_state=opt_state,
              aux=program.GaussianAux.zeros(params.capacity, dev),
              bg=torch.tensor(mix["background"], dtype=torch.float32,
                              device=dev),
              it=mix["first_iteration"], lr_scale=scene.extent(cams),
              step_fn=program.train_step, views=[])

    k = mix["checked_steps"]
    p0 = {g: t.detach().clone() for g, t in params.groups().items()}
    losses = []
    for i in range(mix["warmup_steps"]):
        m = step(st)
        if i < k:
            losses.append(float(m["loss"]))
        if i == 0:
            grad_norms = {g: float(torch.linalg.vector_norm(m)) / (1 - BETA1)
                          for g, m in opt_state.mu.items()}
        if i == k - 1:
            changes = {g: float(torch.linalg.vector_norm(t.detach() - p0[g]))
                       for g, t in params.groups().items()}
            del p0
            ctx.mark("checked steps")
    ctx.mark("warm-up")
    st["checked"] = dict(views=st["views"][:k], losses=losses,
                         grad_norms=grad_norms, changes=changes)
    return st


def step(st) -> dict:
    """One iteration through ``train_step``; returns its metrics (0-d
    device tensors)."""
    v = st["order"].next()
    st["views"].append(v)
    with span("train_step"):
        _, st["aux"], _, m = st["step_fn"](
            st["params"], st["aux"], st["opt_state"], st["batch"].take(
                slice(v, v + 1)), st["bg"], st["it"], st["lr_scale"], 0.0,
            rcfg=st["rcfg"], opt=st["opt"],
            active_sh_degree=st["params"].sh_degree, use_exp=False,
            sparse_adam=False, update_stats=False)
    st["it"] += 1
    return m


def window(st, seconds: float, clock):
    """Iterations until ``seconds`` have passed; the time per iteration is
    the window's start to the end of the last iteration that ended in it,
    over those iterations."""
    t0 = last = clock()
    n = failed = 0
    while True:
        # the overflow flag is read after each iteration, as the trainer's
        # retry reads it; that read waits for the iteration
        over = int(step(st)["overflow"])
        t = clock()
        if t - t0 > seconds:
            break
        n += 1
        failed += over
        last = t
    return {"ms_per_step": (last - t0) * 1e3 / max(n, 1)}, n, failed


def traced(st, steps: int, capture):
    """``steps`` iterations under ``capture()``; keeps the groups they
    start from and their views for the work counts."""
    st["traced_from"] = {g: t.detach().clone()
                         for g, t in st["params"].groups().items()}
    first = len(st["views"])
    with capture():
        failed = sum(int(step(st)["overflow"]) for _ in range(steps))
    st["traced_views"] = st["views"][first:]
    return steps, failed


def release(st) -> dict:
    """Frees the program's state; returns what the check and the work
    counts need."""
    kept = {"checked": st["checked"]}
    kept["traced_from"] = st.get("traced_from")
    kept["traced_views"] = st.get("traced_views", [])
    st.clear()
    return kept


def work(ctx, kept) -> dict:
    from port_bench.work import view_work
    _, _, _, cams = _inputs(ctx)
    g = kept["traced_from"]
    works = [view_work(g, camera_dict(**cams[v], device=ctx.device))
             for v in kept["traced_views"]]
    n_params = sum(t.numel() for t in g.values())
    return {"views": works, "params": n_params, "steps": len(works)}


def follow(ctx, views: list, q=FP32) -> dict:
    """The reference's iterations on ``views`` from the seed's scene."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    s_scene, s_tgt, _, cams = _inputs(ctx)
    g0 = scene.gaussians(cfg, s_scene, dev)
    tg = scene.targets(cfg, s_tgt, dev, len(cams))
    gts = [tg[v].clone() for v in views]
    del tg
    bg = torch.tensor(mix["background"], dtype=torch.float32, device=dev)
    got = ref_train.follow(
        g0, [camera_dict(**cams[v], device=dev) for v in views], gts, bg,
        mix["optimization"], mix["first_iteration"],
        mix["first_iteration"] - 1, scene.extent(cams), q)
    got["changes"] = {k: float(torch.linalg.vector_norm(got["params"][k]
                                                        - g0[k]))
                      for k in g0}
    del got["params"]
    return got


def readings(ref: dict, run: dict) -> dict:
    """The numbers compared: the widest relative gap of a step's loss, and
    by the worst group the gap between the run's norm and the reference's
    of the first gradient and of the change after the checked steps, over
    the larger of the reference's norm and the median group's. Groups whose
    reference gradient is under a thousandth of the median group's (the
    exposure, which this loss does not reach) are left out."""
    med = float(np.median(list(ref["grad_norms"].values())))
    live = [g for g, v in ref["grad_norms"].items() if v >= 1e-3 * med]
    med_c = float(np.median([ref["changes"][g] for g in ref["changes"]]))

    def gap(key, m):
        return max(abs(run[key][g] - ref[key][g]) / max(ref[key][g], m)
                   for g in live)

    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(run["losses"], ref["losses"])),
            "grad_gap": gap("grad_norms", med),
            "change_gap": gap("changes", med_c)}


def check(ctx, kept) -> dict:
    import sys
    c = kept["checked"]
    ref = follow(ctx, c["views"])
    for key in ("grad_norms", "changes"):
        print(f"{key} per group (run, reference): " + ", ".join(
            f"{g} {c[key][g]!r} {ref[key][g]!r}" for g in ref[key]),
            file=sys.stderr)
    return readings(ref, c)
