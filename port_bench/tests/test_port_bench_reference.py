"""The plain reference against the port at a tiny size on the CPU, the
control (the reference in bfloat16 in the program's place) failing the
check, and each fault the cells can have, planted under a run, turning
``correct`` false."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from port_bench import control, faults, run, scene
from port_bench.reference import render as ref
from port_bench.reference import train as ref_train
from port_bench_tiny import make_root

SEED = 2_147_483_659


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return make_root(tmp_path_factory.mktemp("bench"))


def _ctx(root, workload, seed=SEED):
    spec = run.load_spec(root)
    cell, cfg, mix = run.resolve(spec, root, workload)
    return run.Context(cell, cfg, mix, seed, torch.device("cpu"), False)


def _program_and_reference(ctx):
    from port_bench import program
    cfg = ctx.cfg
    g = scene.gaussians(cfg, 7, "cpu")
    cams = scene.train_cameras(cfg, 8)
    p = program.params({k: v.clone() for k, v in g.items()}, 3)
    bg = torch.tensor([0.2, 0.1, 0.0])
    return g, cams, p, bg, program


@pytest.mark.parametrize("view", [0, 3])
def test_reference_render_matches_the_port(root, view):
    g, cams, p, bg, program = _program_and_reference(
        _ctx(root, "serve-tiny"))
    with torch.no_grad():
        got = program.render(p, program.camera(cams[view], 0, "cpu"), bg,
                             active_sh_degree=3).render
        want, info = ref.render(g, ref.camera_dict(**cams[view],
                                                   device="cpu"), bg)
    assert info["n_live"] > 0
    assert float((got - want).abs().max()) < 1e-5


def test_reference_gradients_match_the_port(root):
    ctx = _ctx(root, "train-tiny")
    g, cams, p, bg, program = _program_and_reference(ctx)
    from gslm_tpu_torch.solver.residuals import scalar_training_loss
    gt = scene.targets(ctx.cfg, 9, "cpu", 1)
    batch = program.camera_batch(cams[:1], gt, "cpu")
    loss, _ = scalar_training_loss(p, batch, bg, active_sh_degree=3)
    grads = torch.autograd.grad(loss, [getattr(p, k) for k in
                                       ref_train.GROUPS[:-1]])
    leaves = {k: v.clone().requires_grad_(True) for k, v in g.items()}
    image, _ = ref.render(leaves, ref.camera_dict(**cams[0], device="cpu"),
                          bg)
    rloss = ref_train.loss_of(image, gt[0], 0.2)
    rgrads = torch.autograd.grad(rloss, [leaves[k] for k in
                                         ref_train.GROUPS[:-1]])
    assert abs(float(loss) - float(rloss)) < 1e-6
    for a, b in zip(grads, rgrads):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12


@pytest.mark.parametrize("workload", ["train-tiny", "serve-tiny"])
def test_control_fails_the_check(root, workload):
    ctx = _ctx(root, workload)
    got = control.control_readings(ctx)
    limits = ctx.mix["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in (("train-tiny", faults.FAULTS["train"]),
                         ("serve-tiny", faults.FAULTS["serve"]))
    for f in fs])
def test_a_planted_fault_turns_correct_false(root, capsys, workload, fault):
    with faults.plant(fault):
        got = run.main(["--workload", workload, "--seed", str(SEED),
                        "--seconds", "1"], root=root, device="cpu")
    capsys.readouterr()
    assert got["correct"] is False, got["checks"]
    # and the program is whole again once the block has closed
    got = run.main(["--workload", workload, "--seed", str(SEED),
                    "--seconds", "1"], root=root, device="cpu")
    assert got["correct"] is True, got["checks"]


def test_state_left_unchanged_reads_one(root):
    ctx = _ctx(root, "train-tiny")
    from port_bench.kinds import train
    views = [0, 1, 2]
    refd = train.follow(ctx, views)
    run_ = dict(refd, changes={k: 0.0 for k in refd["changes"]})
    assert train.readings(refd, run_)["change_gap"] == pytest.approx(1.0)


def test_control_runner_prints_one_line_per_seed(root, capsys):
    out = control.main(["--workload", "serve-tiny", "--seeds", "4,5"],
                       root=root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [4, 5] == [x["seed"] for x in out]
    assert all(np.isfinite(x["image_gap"]) for x in lines)
