"""Mix kind ``serve``: one viewer client in a closed loop, as the viewer
serves a frame for each camera it receives (``viewer/network_gui.py``): the
next request comes once the frame before it is on the host. Each frame is
``renderer.render`` of the next pose of an orbit under ``torch.no_grad()``,
clamp, ×255, a copy to the host and the 8-bit frame. The orbit starts at a
seeded pose.

Before the window the frames to check are drawn from the seed among the
first ``check_among`` (``checked``); each one the window completes keeps its
float frame (already on the host) and its 8-bit frame. The check renders
those poses with the plain reference.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import scene
from port_bench.reference.render import FP32, camera_dict, render as ref_render
from port_bench.trace import span


def _inputs(ctx):
    s_scene, s_start, s_check = scene.seeds(ctx.seed, 3)
    cams = scene.orbit_cameras(ctx.cfg, ctx.mix["orbit"])
    start = int(np.random.default_rng(s_start).integers(len(cams)))
    return s_scene, s_check, cams, start


def checked(ctx) -> list:
    """The indices of the frames the check compares, drawn from the seed
    among the first ``check_among`` (the traced ones when traced)."""
    _, s_check, _, _ = _inputs(ctx)
    among = ctx.mix["trace_steps"] if ctx.trace else ctx.mix["check_among"]
    rng = np.random.default_rng(s_check)
    return sorted(int(i) for i in rng.choice(
        among, min(ctx.mix["checked_frames"], among), replace=False))


def setup(ctx):
    from port_bench import program
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    s_scene, _, cams, start = _inputs(ctx)
    params = program.params(scene.gaussians(cfg, s_scene, dev),
                            cfg["sh_degree"])
    ctx.mark("scene")
    n = len(cams)
    probe = [(start + i * n // mix["probe_views"]) % n
             for i in range(mix["probe_views"])]
    rcfg = program.raster_config(
        params, program.camera_batch([cams[i] for i in probe], None, dev),
        mix["capacity_headroom"])
    st = dict(params=params, rcfg=rcfg, render=program.render,
              cams=[program.camera(c, 0, dev) for c in cams], pose=start,
              bg=torch.tensor(mix["background"], dtype=torch.float32,
                              device=dev),
              frames=0, kept={})
    ctx.mark("capacity probe")
    for _ in range(mix["warmup_frames"]):
        frame(st)
    ctx.mark("warm-up")
    st["pose"], st["frames"] = start, 0
    st["check"] = set(checked(ctx))
    return st


def frame(st) -> int:
    """One viewer frame; returns the render's overflow flag."""
    pose = st["pose"]
    with torch.no_grad(), span("render"):
        out = st["render"](st["params"], st["cams"][pose], st["bg"],
                           config=st["rcfg"],
                           active_sh_degree=st["params"].sh_degree,
                           alive=st["params"].alive)
        scaled = torch.clamp(out.render, 0, 1) * 255
    with span("frame_to_host"):
        arr = scaled.cpu().numpy()
        img = np.ascontiguousarray(arr.astype(np.uint8).transpose(1, 2, 0))
    if st["frames"] in st.get("check", ()):
        st["kept"][st["frames"]] = (pose, arr, img)
    st["frames"] += 1
    st["pose"] = (pose + 1) % len(st["cams"])
    return int(out.overflow)


def window(st, seconds: float, clock):
    """Frames, each requested once the one before is on the host, until
    ``seconds`` have passed. Returns the frames completed per second: those
    that ended in the window over the window's start to the end of the
    last of them."""
    t0 = last = clock()
    n = failed = 0
    while True:
        over = frame(st)
        t = clock()
        if t - t0 > seconds:
            st["kept"].pop(st["frames"] - 1, None)   # not in the window
            break
        n += 1
        failed += over
        last = t
    return {"frames_per_s": n / (last - t0) if n else 0.0}, n, failed


def traced(st, steps: int, capture):
    first = st["pose"]
    with capture():
        failed = sum(frame(st) for _ in range(steps))
    st["traced_poses"] = [(first + i) % len(st["cams"]) for i in range(steps)]
    return steps, failed


def release(st) -> dict:
    kept = {"frames": st["kept"], "traced_poses": st.get("traced_poses", [])}
    st.clear()
    return kept


def work(ctx, kept) -> dict:
    from port_bench.work import view_work
    s_scene, _, cams, _ = _inputs(ctx)
    g = scene.gaussians(ctx.cfg, s_scene, ctx.device)
    works = [view_work(g, camera_dict(**cams[p], device=ctx.device))
             for p in kept["traced_poses"]]
    return {"views": works, "params": sum(t.numel() for t in g.values()),
            "steps": len(works)}


def reference_frames(ctx, poses: list, q=FP32) -> list:
    """The reference's float frames (×255, H, W last) of ``poses``."""
    s_scene, _, cams, _ = _inputs(ctx)
    g = scene.gaussians(ctx.cfg, s_scene, ctx.device)
    bg = torch.tensor(ctx.mix["background"], dtype=torch.float32,
                      device=ctx.device)
    out = []
    with torch.no_grad():
        for p in poses:
            img, _ = ref_render(g, camera_dict(**cams[p], device=ctx.device),
                                bg, q)
            out.append((torch.clamp(img, 0, 1) * 255).cpu().numpy())
    return out


def readings(ref: list, run: list, served: list) -> dict:
    """Over the checked frames: the widest and the mean gap of the float
    frame's values (on the [0, 1] scale), and the widest gap of the 8-bit
    frame served (H, W, 3) against the reference's cast. A pair of splats
    at the 1/255 alpha gate can flip one pixel by up to ~0.006 between two
    sound compositors, so the widest gap swings; the mean does not."""
    gaps = [np.abs(a - b) / 255.0 for a, b in zip(run, ref)]
    frame_gap = max(int(np.abs(u.astype(np.int16) - b.astype(np.uint8)
                               .transpose(1, 2, 0).astype(np.int16)).max())
                    for u, b in zip(served, ref))
    return {"image_gap": float(max(g.max() for g in gaps)),
            "image_mean_gap": float(np.mean([g.mean() for g in gaps])),
            "frame_gap": float(frame_gap)}


def check(ctx, kept) -> dict:
    frames = [kept["frames"][k] for k in sorted(kept["frames"])]
    if not frames:
        raise RuntimeError("no checked frame was due in the window")
    ref = reference_frames(ctx, [p for p, _, _ in frames])
    return readings(ref, [a for _, a, _ in frames], [u for _, _, u in frames])
