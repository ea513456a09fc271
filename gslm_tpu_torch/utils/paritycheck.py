"""On-card parity matrix of the CUDA kernels (gslm_tpu/utils/paritycheck.py).

One call holds the kernel path on the card against the same calls on CPU
tensors, where every kernel wrapper takes its plain PyTorch version:

  - the forward image (kernel A),
  - all 7 parameter-group gradients through the backward compositor
    (kernel C), with culling on and off,
  - bucket binning at 2 and 4 (kernel A with the rect gate, kernel D),
  - a fused 2-view batch (tile rows wrapping per view),
  - J·v of the image (kernel E), and J·v through the LM residual
    operator (``LMOperators.matvec`` of ``batch_residuals``, the path
    CGLS consumes).

Every input is built once in numpy from the JAX matrix's seeds (2,048
Gaussians of ``random_gaussians(rng 7)`` at 160x192, or 512 at 96x128
with ``quick``) and run on both devices; the tolerances are JAX's. The
JAX matrix's reference side is its XLA tile pipeline, which the port does
not have: its plain versions take that role. Two of its variants are
dropped: ``grads_sortseg`` and ``grads_pack8`` select the sorted-segment
cotangent reduction and the 8-record lane packing of the TPU kernels,
which the port does not have (the cotangents reach the Gaussians by
scatter-add, and each CUDA kernel picks its own layout).

``python -m gslm_tpu_torch.utils.paritycheck [--quick]`` prints the
table; ``run_parity_matrix`` returns it. Both need CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from gslm_tpu_torch.models.gaussians import PARAM_GROUPS as GROUPS

# gradient gate: per group, the largest error relative to the group's
# largest gradient (the reference pins gradients at atol 1e-5 on unit-scale
# losses); images are in [0, 1]: absolute
GRAD_RTOL = 1e-4
IMG_ATOL = 1e-5

VARIANTS = ("fwd_image", "grads_scatter", "grads_nocull", "fwd_bucket2",
            "grads_bucket2", "fwd_bucket4", "grads_bucket4", "grads_batch2",
            "jvp_image", "jvp_lm_operator")


def _grad_errs(ga: dict, gb: dict) -> dict:
    """Per-group max error of gb vs ga, normalised by ga's scale."""
    errs = {}
    for k in GROUPS:
        a = np.asarray(ga[k], np.float64)
        b = np.asarray(gb[k], np.float64)
        scale = np.abs(a).max() + 1e-12
        errs[k] = float(np.abs(b - a).max() / scale)
    return errs


def _inputs(quick: bool) -> dict:
    """The matrix's inputs as numpy: the scene's seven groups and alive
    mask, the targets, the tangent, the sizes."""
    from gslm_tpu_torch.utils.synthetic import random_gaussians

    n = 512 if quick else 2048
    H, W = (96, 128) if quick else (160, 192)
    # bucket 4 needs tile rows % 4 == 0: its own 192-tall camera
    H4 = 128 if quick else 192
    p = random_gaussians(np.random.default_rng(7), n=n, capacity=n,
                         num_images=4, device="cpu")
    groups = {g: getattr(p, g).detach().numpy() for g in GROUPS}
    return dict(
        groups=groups, alive=p.alive.numpy(), sh_degree=p.sh_degree,
        H=H, W=W, H4=H4, dup=1 << (13 if quick else 14),
        gt=np.random.default_rng(8).uniform(0, 1, (3, H, W)).astype(
            np.float32),
        gt4=np.random.default_rng(8).uniform(0, 1, (3, H4, W)).astype(
            np.float32),
        # one fresh draw per group, as JAX's tree.map of the params does
        tangent={g: np.random.default_rng(9).normal(0, 1e-3, x.shape)
                 .astype(np.float32) for g, x in groups.items()})


def _outputs(inp: dict, dev: torch.device) -> dict:
    """Every variant's images, gradients and tangents on ``dev``, as
    numpy."""
    import torch.autograd.forward_ad as fwAD

    from gslm_tpu_torch.models.cameras import camera_from_meta
    from gslm_tpu_torch.models.gaussians import params_from_numpy, with_groups
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.renderer import batch_render, render
    from gslm_tpu_torch.solver.operators import LMOperators
    from gslm_tpu_torch.solver.residuals import batch_residuals
    from gslm_tpu_torch.utils.synthetic import make_camera, ring_camera_batch

    H, W, H4 = inp["H"], inp["W"], inp["H4"]
    cfg = RasterConfig(dup_capacity=inp["dup"])
    bcfg = cfg.replace(dup_capacity=2 * cfg.dup_capacity)
    bg = torch.zeros(3, device=dev)

    def params():
        return params_from_numpy(inp["groups"], inp["sh_degree"],
                                 inp["alive"], device=dev)

    cam = camera_from_meta(make_camera(height=H, width=W), device=dev)
    cam4 = camera_from_meta(make_camera(height=H4, width=W), device=dev)
    cams = ring_camera_batch(2, H, W, device=dev)
    gt = torch.tensor(inp["gt"], device=dev)
    gt4 = torch.tensor(inp["gt4"], device=dev)

    def grad_of(c, camera=cam, target=gt):
        # use_trained_exp so the 7th group (exposure) carries gradient
        p = params()
        img = render(p, camera, bg, config=c, use_trained_exp=True).render
        loss = torch.sum((img - target) ** 2)
        found = torch.autograd.grad(loss, [getattr(p, g) for g in GROUPS])
        return (img.detach().cpu().numpy(),
                {g: d.cpu().numpy() for g, d in zip(GROUPS, found)})

    def batch_grads(c):
        p = params()
        out = batch_render(p, cams, bg, config=c, use_trained_exp=True)
        loss = torch.sum((out.render - cams.gt_image) ** 2)
        found = torch.autograd.grad(loss, [getattr(p, g) for g in GROUPS])
        return {g: d.cpu().numpy() for g, d in zip(GROUPS, found)}

    tangent = {g: torch.tensor(t, device=dev)
               for g, t in inp["tangent"].items()}

    def jvp_image(c):
        p = params()
        with torch.no_grad(), fwAD.dual_level():
            duals = {g: fwAD.make_dual(getattr(p, g).detach(), tangent[g])
                     for g in GROUPS}
            img = render(with_groups(p, duals), cam, bg, config=c).render
            return fwAD.unpack_dual(img).tangent.cpu().numpy()

    def jvp_residual(c):
        ops = LMOperators(
            lambda q: batch_residuals(q, cams, bg, config=c,
                                      disable_ssim=True),
            params(), reuse_linearization=False)
        return ops.matvec(tangent).l1.cpu().numpy()

    out = {}
    out["image"], out["grads"] = grad_of(cfg)
    out["grads_nocull"] = grad_of(cfg.replace(cull=False))[1]
    out["image_bucket2"], out["grads_bucket2"] = grad_of(
        cfg.replace(bucket=2))
    out["image_bucket4"], out["grads_bucket4"] = grad_of(
        cfg.replace(bucket=4), cam4, gt4)
    out["grads_batch2"] = batch_grads(bcfg)
    out["jvp_image"] = jvp_image(cfg)
    out["jvp_residual"] = jvp_residual(bcfg)
    return out


def _compare(got: dict, want: dict) -> dict:
    """The matrix: each variant's ``ok`` at the gate tolerance, its worst
    error and, for gradients, the error per group."""
    results: dict[str, dict] = {}

    def record_image(name, a, b):
        results[name] = {"ok": bool(np.allclose(a, b, atol=IMG_ATOL)),
                         "max_err": float(np.abs(a - b).max())}

    def record_grads(name, gb, ga):
        errs = _grad_errs(ga, gb)
        worst = max(errs.values())
        results[name] = {"ok": worst < GRAD_RTOL, "max_err": worst,
                         "per_group": {k: round(v, 9)
                                       for k, v in errs.items()}}

    record_image("fwd_image", got["image"], want["image"])
    record_grads("grads_scatter", got["grads"], want["grads"])
    record_grads("grads_nocull", got["grads_nocull"], want["grads_nocull"])
    record_image("fwd_bucket2", got["image_bucket2"], want["image_bucket2"])
    record_grads("grads_bucket2", got["grads_bucket2"], want["grads_bucket2"])
    record_image("fwd_bucket4", got["image_bucket4"], want["image_bucket4"])
    record_grads("grads_bucket4", got["grads_bucket4"], want["grads_bucket4"])
    record_grads("grads_batch2", got["grads_batch2"], want["grads_batch2"])

    jv, jv_ref = got["jvp_image"], want["jvp_image"]
    jsc = float(np.abs(jv_ref).max()) + 1e-12
    results["jvp_image"] = {
        "ok": bool(np.allclose(jv, jv_ref, atol=IMG_ATOL * 10, rtol=1e-4)),
        "max_err": float(np.abs(jv - jv_ref).max()) / jsc}
    rv, rv_ref = got["jvp_residual"], want["jvp_residual"]
    rel = float(np.abs(rv - rv_ref).max()) / (float(np.abs(rv_ref).max())
                                              + 1e-12)
    results["jvp_lm_operator"] = {"ok": rel < GRAD_RTOL, "max_err": rel}
    assert tuple(results) == VARIANTS
    return {"ok": all(v["ok"] for v in results.values()),
            "variants": results}


def _outputs_on(inp: dict, dev) -> dict:
    """``_outputs`` on ``dev``; on the CPU with deterministic algorithms
    (its parallel scatter-adds onto shared bucket records otherwise sum in
    a varying order), so the reference side is one repeatable value."""
    dev = torch.device(dev)
    if dev.type != "cpu":
        return _outputs(inp, dev)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _outputs(inp, dev)
    finally:
        torch.use_deterministic_algorithms(was)


def _run(kernel_dev, ref_dev, quick: bool = False) -> dict:
    """The matrix of ``kernel_dev``'s outputs against ``ref_dev``'s on the
    same inputs."""
    inp = _inputs(quick)
    return _compare(_outputs_on(inp, kernel_dev), _outputs_on(inp, ref_dev))


def run_parity_matrix(quick: bool = False) -> dict:
    """The kernels on the card against their plain versions on the CPU:
    ``{"ok", "variants": {name: {"ok", "max_err"[, "per_group"]}}}``.
    ``quick`` shrinks the scene. Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the parity matrix holds "
                           "the CUDA kernels against their plain versions")
    return _run("cuda", "cpu", quick)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    out = run_parity_matrix(quick=args.quick)
    for name, v in out["variants"].items():
        flag = "PASS" if v["ok"] else "FAIL"
        print(f"{name:18s} {flag}  max_err={v['max_err']:.3e}")
    print(json.dumps({"ok": out["ok"]}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
