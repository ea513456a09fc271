"""gslm_tpu_torch's trainer loop and command lines (train.py, train_lm.py,
train_sgd.py) against gslm_tpu's on the CPU.

JAX runs its own ``training`` on ``tests/synthetic_scene``'s 8-view COLMAP
scene (``--eval``: 7 train views, 1 test view) with ``--platform cpu``, as
its non-slow training tests run it (XLA's tiled rasterizer); the port runs
its ``training`` from the same arguments through the plain versions of
kernels A, B and C. The split noise of each density event is JAX's own
draw (``split_noise`` patched with ``PRNGKey(0)`` split per event, then
``split(sub)`` and ``normal((C, 3))`` twice, as gslm_tpu/densify.py does).

Tolerances: the view order, the windows, ``make_raster_config``, the
density counts, ``alive``, ``opt_state.step`` and the file sets are equal.
Parameters and Adam moments after the 14 iterations (two density events,
an opacity reset) or the 7 resumed ones are held entry by entry
(``_assert_params``), in units of each group's learning rate ``lr``:

- every entry within ``STEPS`` = 0.1 lr of JAX's (0.046 lr measured), and
  the moments within ``MOMENT_TOL`` = 1e-2 of the group's largest |JAX|
  (3.3e-3 measured), except on two knife edges, where a gradient that is
  exactly 0 in one package is rounding noise in the other and Adam's
  eps = 1e-15 turns the noise into whole steps of ~lr:
- the colour channels at the colour clamp's 0 (ROADMAP §3): within
  ``EDGE_STEPS`` = 4.5 lr (4.01 lr measured after 7 resumed iterations,
  2.97 after 14), their moments not compared;
- in the 14-iteration run, the rotation of one Gaussian whose scaling is
  still near isotropic at iteration 2 (JAX's rotation gradient exactly 0,
  the port's ~1e-11, a 0.74 lr step), and its three copies from the
  density events: ``LINEAGE_ROWS`` = 4 rows within ``LINEAGE_STEPS`` =
  2.5 lr (1.99 lr measured).

The overflow retry and the other command lines are in
``test_torch_trainer_cli.py``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

import gslm_tpu.config as j_cfg
import gslm_tpu.train as j_train
from gslm_tpu.checkpoint import load_checkpoint as j_load_checkpoint
from gslm_tpu.data.ply import load_gaussians_ply as j_load_ply
from gslm_tpu.train_sgd import select_window as j_select_window
from gslm_tpu_torch import config as cfg_mod
from gslm_tpu_torch import train as t_train
from gslm_tpu_torch.checkpoint import load_checkpoint
from gslm_tpu_torch.data.ply import load_gaussians_ply
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from gslm_tpu_torch.train_sgd import select_window
from tests.synthetic_scene import build_colmap_scene

ITERS = 14
STEPS = 0.1
MOMENT_TOL = 1e-2
EDGE_STEPS = 4.5
LINEAGE_ROWS, LINEAGE_STEPS = 4, 2.5
C0 = 0.28209479177387814


@pytest.fixture(autouse=True)
def _keep_stdout():
    """``training`` wraps sys.stdout for the rest of the process
    (safe_state): put the original back after each test."""
    saved = sys.stdout
    yield
    sys.stdout = saved


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return build_colmap_scene(str(tmp_path_factory.mktemp("scene") / "src"),
                              n_views=8)


def _argv(src, model, **over):
    flags = {"iterations": ITERS, "densify_from_iter": 4,
             "densification_interval": 5, "opacity_reset_interval": 12,
             "capacity": 256, "test_iterations": [7, ITERS],
             "save_iterations": [ITERS], "checkpoint_iterations": [7, ITERS]}
    flags.update(over)
    argv = ["-s", src, "-m", model, "--eval", "--platform", "cpu",
            "--disable_viewer"]
    for k, v in flags.items():
        if v is True:
            argv.append(f"--{k}")
        elif v is not None:
            argv += [f"--{k}"] + [str(x) for x in np.atleast_1d(v)]
    return argv


def _jax_noise():
    """A ``split_noise`` giving JAX's draws, event after event."""
    key = [jax.random.PRNGKey(0)]

    def draw(gen, capacity, device):
        key[0], sub = jax.random.split(key[0])
        return tuple(torch.tensor(np.asarray(jax.random.normal(k, (capacity,
                                                                   3))))
                     for k in jax.random.split(sub))
    return draw


class _Record:
    """Wraps a loop's step and density calls: the view of each attempt
    (its exposure index) and each density event's counts."""

    def __init__(self, monkeypatch, module, step_name):
        self.views, self.events = [], []
        real_step = getattr(module, step_name)
        real_densify = module.densify_and_prune

        def step(params, *a, **k):
            cam = a[2] if step_name == "train_step" else a[0]
            self.views.append(int(np.asarray(cam.exposure_idx)[0]))
            return real_step(params, *a, **k)

        def densify(*a, **k):
            out = real_densify(*a, **k)
            self.events.append({n: int(v) for n, v in out[3].items()})
            return out

        monkeypatch.setattr(module, step_name, step)
        monkeypatch.setattr(module, "densify_and_prune", densify)


def _run_jax(monkeypatch, argv, rec=True):
    parser = j_train.build_parser()
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    with monkeypatch.context() as m:
        r = _Record(m, j_train, "train_step") if rec else None
        scene, params, aux, opt_state = j_train.training(args)
    return r, scene, params, aux, opt_state


def _run_port(monkeypatch, argv, rec=True):
    with monkeypatch.context() as m:
        m.setattr(t_train, "split_noise", _jax_noise())
        r = _Record(m, t_train, "loss_and_grads") if rec else None
        scene, params, aux, opt_state = t_train.main(argv)
    return r, scene, params, aux, opt_state


def _assert_params(jrun, trun, lineage_rows=0):
    """``alive`` equal; parameters and moments entry by entry, as the
    module's docstring states. Colour channels at the clamp's 0 in JAX's
    final state are the colour knife edge (JAX never moves them); rows
    with an entry beyond ``STEPS`` are counted against ``lineage_rows``."""
    _, _, jp, jaux, jopt = jrun
    _, tscene, tp, _, topt = trun
    opt = cfg_mod.OptimizationParams()
    lrs = {"xyz": opt.position_lr_init * tscene.cameras_extent,
           "features_dc": opt.feature_lr,
           "features_rest": opt.feature_lr / 20.0,
           "scaling": opt.scaling_lr, "rotation": opt.rotation_lr,
           "opacity": opt.opacity_lr, "exposure": opt.exposure_lr_init}
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jaux.alive))
    jdc = np.asarray(jp.features_dc)
    edge = np.abs(C0 * jdc + 0.5) <= 1e-6
    assert edge.sum() < edge.size // 2
    off_rows = set()
    for g in PARAM_GROUPS:
        want = np.asarray(getattr(jp, g))
        steps = np.abs(getattr(tp, g).detach().numpy() - want) / lrs[g]
        on = edge if g == "features_dc" else np.zeros(want.shape, bool)
        assert steps[on].max(initial=0.0) <= EDGE_STEPS, g
        beyond = (steps > STEPS) & ~on
        off_rows |= set(np.nonzero(beyond.reshape(len(want), -1).any(1))[0]
                        .tolist())
        assert steps[beyond].max(initial=0.0) <= LINEAGE_STEPS, g
        for got, ref in ((topt.mu[g], getattr(jopt.mu, g)),
                         (topt.nu[g], getattr(jopt.nu, g))):
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                got.numpy()[~on], ref[~on], rtol=0,
                atol=MOMENT_TOL * np.abs(ref).max(initial=0.0), err_msg=g)
    assert len(off_rows) <= lineage_rows, sorted(off_rows)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if not f.startswith("events.out.tfevents"))


@pytest.fixture(scope="module")
def loop_runs(scene_dir, tmp_path_factory):
    """JAX's and the port's ``training`` from the same command line."""
    root = tmp_path_factory.mktemp("loop")
    mp = pytest.MonkeyPatch()
    saved = sys.stdout
    try:
        jrun = _run_jax(mp, _argv(scene_dir, str(root / "jax")))
        trun = _run_port(mp, _argv(scene_dir, str(root / "port")))
    finally:
        sys.stdout = saved
        mp.undo()
    return root, jrun, trun, scene_dir


@pytest.mark.parametrize("tpu,pipe,hw,n", [
    ({}, {}, (1080, 1920), 100), ({}, {}, (1080, 1920), 131_072),
    ({"dup_capacity": 1 << 16}, {"antialiasing": True}, (64, 64), 5000),
    ({"live_capacity": 12345}, {}, (64, 96), 300),
    ({"raster_cull": False}, {}, (64, 64), 300)])
def test_make_raster_config_field_for_field(tpu, pipe, hw, n):
    want = j_train.make_raster_config(j_cfg.TpuParams(**tpu),
                                      j_cfg.PipelineParams(**pipe), *hw, n)
    got = t_train.make_raster_config(cfg_mod.TpuParams(**tpu),
                                     cfg_mod.PipelineParams(**pipe), *hw, n)
    for f in dataclasses.fields(got):
        if f.name in ("tile_chunk", "pack", "mp_route_capacity", "chunk_rows",
                      "bucket", "depth_grad"):
            continue     # TPU-only, or not set by make_raster_config
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_select_window_matches_jax():
    for seed in range(100):
        for num_cams, num_images in ((8, 5), (20, 3), (4, 6), (1, 1)):
            a = select_window(num_cams, num_images,
                              np.random.default_rng(seed))
            b = j_select_window(num_cams, num_images,
                                np.random.default_rng(seed))
            assert a == b, (seed, num_cams, num_images)


def test_view_order_two_epochs_matches_jax(loop_runs):
    _, (jrec, jscene, *_), (trec, tscene, *_), _ = loop_runs
    names = [[s.get_train_cameras()[i].image_name for i in r.views]
             for s, r in ((jscene, jrec), (tscene, trec))]
    assert len(names[0]) == ITERS == 2 * len(jscene.get_train_cameras())
    assert names[1] == names[0]
    assert sorted(names[0][:7]) == sorted(names[0][7:])


def test_loop_matches_jax(loop_runs):
    """14 iterations: density events after 5 and 10, an opacity reset at
    12, test iterations 7 and 14, a save and two checkpoints."""
    root, (jrec, *_, jopt), (trec, *_, topt), _ = loop_runs
    assert trec.events == jrec.events and len(trec.events) == 2
    assert all(e["n_cloned"] + e["n_split"] > 0 for e in trec.events)
    assert topt.step == int(jopt.step) == ITERS
    _assert_params(loop_runs[1], loop_runs[2], lineage_rows=LINEAGE_ROWS)
    assert _files(root / "port") == _files(root / "jax")
    assert "chkpnt7.npz" in _files(root / "port")


def test_loop_outputs_load_in_both_packages(loop_runs):
    root, (_, _, jp, jaux, jopt), (_, _, tp, taux, topt), _ = loop_runs
    ply = os.path.join("point_cloud", f"iteration_{ITERS}", "point_cloud.ply")
    for a, b in ((root / "port", root / "jax"),):
        mine = load_gaussians_ply(str(a / ply))
        theirs = j_load_ply(str(a / ply))
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])
        mine, theirs = load_gaussians_ply(str(b / ply)), j_load_ply(
            str(b / ply))
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])
    ck = f"chkpnt{ITERS}.npz"
    p, aux, st, it, scale = load_checkpoint(str(root / "port" / ck),
                                            device="cpu")
    jq, jqa, jqs, jit_, jscale = j_load_checkpoint(str(root / "port" / ck))
    assert (it, int(jqs.step), scale) == (jit_, st.step, jscale)
    for g in PARAM_GROUPS:
        np.testing.assert_array_equal(np.asarray(getattr(jq, g)),
                                      getattr(tp, g).detach().numpy())
    np.testing.assert_array_equal(np.asarray(jqa.alive), tp.alive.numpy())
    jq, jqa, jqs, _, _ = j_load_checkpoint(str(root / "jax" / ck))
    p, aux, st, _, _ = load_checkpoint(str(root / "jax" / ck), device="cpu")
    for g in PARAM_GROUPS:
        np.testing.assert_array_equal(getattr(p, g).detach().numpy(),
                                      np.asarray(getattr(jp, g)))
        np.testing.assert_array_equal(st.mu[g].numpy(),
                                      np.asarray(getattr(jopt.mu, g)))
    np.testing.assert_array_equal(p.alive.numpy(), np.asarray(jaux.alive))
    assert st.step == int(jopt.step)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(loop_runs, monkeypatch, writer):
    """One package's checkpoint at iteration 7, resumed by both packages'
    ``training`` for iterations 8-14 (a density event after 10): the runs
    agree (each restarts its own draws at a resume)."""
    root, src = loop_runs[0], loop_runs[3]
    over = dict(start_checkpoint=str(root / writer / "chkpnt7.npz"),
                test_iterations=[ITERS], checkpoint_iterations=None)
    jrun = _run_jax(
        monkeypatch, _argv(src, str(root / f"resume_{writer}_jax"), **over))
    trun = _run_port(
        monkeypatch, _argv(src, str(root / f"resume_{writer}_port"), **over))
    (jrec, *_, jopt), (trec, *_, topt) = jrun, trun
    assert trec.views == jrec.views and len(trec.views) == ITERS - 7
    assert trec.events == jrec.events and len(trec.events) == 1
    assert topt.step == int(jopt.step) == ITERS
    _assert_params(jrun, trun)
