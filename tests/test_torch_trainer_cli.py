"""gslm_tpu_torch's trainer command lines on the CPU: the overflow retry of
``training`` against gslm_tpu's, ``train_lm.main`` (Adam, then LM),
``train_sgd.main``, ``--quiet`` and the device rule.

Tolerances: a retried iteration starts from the same state as JAX's and
applies one Adam step from it: ``opt_state.step`` exactly; parameters
and moments to 1e-5, but on the knife edge: the blob scene's colour
channels that sit at the colour clamp's 0, which XLA's fused
multiply-add rounds just below 0 (the clamp blocks the gradient) and the
port's separate multiply and add to exactly 0 (the clamp passes it, as
the reference CUDA's does). There the port's parameters may be one step
of the group's learning rate away (Adam's eps = 1e-15 makes any nonzero
gradient a whole step), the edge entries counted from the initial
colours. Against the port's own run that starts at the grown capacity, bit for
bit. The LM windows equal JAX's draws
exactly.
"""

import io
import os
import random
import re
import sys

import numpy as np
import pytest
import torch

import gslm_tpu.train as j_train
import gslm_tpu.utils.general as j_general
from gslm_tpu.train_lm import select_window as j_lm_window
from gslm_tpu_torch import train as t_train
from gslm_tpu_torch import train_lm as t_train_lm
from gslm_tpu_torch import train_sgd as t_train_sgd
from gslm_tpu_torch.models.cameras import batch_from_metas
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from gslm_tpu_torch.models.scene import Scene
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.renderer import overflow_probe
from gslm_tpu_torch.utils.general import safe_state
from tests.synthetic_scene import build_colmap_scene
from tests.test_torch_trainer import MOMENT_TOL, _restore_stdout
from torch_threads import one_thread  # noqa: F401 (autouse)

STEP_ATOL = 1e-5
STARVED = 128     # records: below every train view's 162-185, above half


@pytest.fixture(autouse=True)
def _keep_stdout():
    """``training`` wraps sys.stdout for the rest of the process
    (safe_state), and JAX's safe_state keeps the first stream it wrapped
    in a module global: each test starts with that global cleared and ends
    with both put back (``tests/test_torch_trainer.py::_restore_stdout``).
    Else a JAX ``training`` run earlier in the process, under pytest's
    stream, would send this file's JAX output past ``_capture``."""
    saved = sys.stdout
    j_general._SAFE_STATE_ORIG = None
    yield
    _restore_stdout(saved)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return build_colmap_scene(str(tmp_path_factory.mktemp("scene") / "src"),
                              n_views=8)


def _argv(src, model, *extra):
    return ["-s", src, "-m", model, "--eval", "--platform", "cpu",
            "--disable_viewer", "--capacity", "256", "--densify_from_iter",
            "1000", *map(str, extra)]


def _capture(fn):
    """Run ``fn`` with stdout in a buffer; returns (its result, the text)."""
    saved, buf = sys.stdout, io.StringIO()
    sys.stdout = buf
    try:
        return fn(), buf.getvalue()
    finally:
        sys.stdout = saved


def test_retried_iteration_applies_adam_once(scene_dir, tmp_path):
    """Iteration 1 at ``--dup_capacity 128`` overflows once and is re-run
    at 256: the port's parameters, moments and step after it equal JAX's,
    and equal a port run that starts at 256."""
    # the loop's first view: the view order after the Scene's shuffles
    rng = random.Random(0)
    scene = Scene(scene_dir, str(tmp_path / "probe"), eval_split=True,
                  capacity=256, device="cpu", rng=rng)
    order = list(range(len(scene.get_train_cameras())))
    rng.shuffle(order)
    first = batch_from_metas([scene.get_train_cameras()[order.pop()]],
                             device="cpu")
    need = int(overflow_probe(scene.params, first, config=RasterConfig(
        dup_capacity=1 << 20), active_sh_degree=0)["n_aabb"])
    assert STARVED < need <= 2 * STARVED

    argv = _argv(scene_dir, str(tmp_path / "port"), "--iterations", 1,
                 "--dup_capacity", STARVED)
    (_, tp, _, topt), text = _capture(lambda: t_train.main(argv))
    assert (f"[ITER 1] duplicate-buffer overflow: retrying at "
            f"dup_capacity={2 * STARVED}") in text
    assert "WARNING" not in text and topt.step == 1

    jargs = j_train.build_parser().parse_args(
        _argv(scene_dir, str(tmp_path / "jax"), "--iterations", 1,
              "--dup_capacity", STARVED))
    (_, jp, _, jopt), jtext = _capture(lambda: j_train.training(jargs))
    assert "retrying at dup_capacity=256" in jtext
    assert int(jopt.step) == 1
    lrs = t_train.group_learning_rates(t_train.OptimizationParams(), 1,
                                       scene.cameras_extent)
    # colour channels at the colour clamp's 0 (the knife edge): the
    # gradient there passes in the port and not in JAX
    dc = scene.params.features_dc.detach().double()
    edge = {g: np.zeros(getattr(tp, g).shape, bool) for g in PARAM_GROUPS}
    edge["features_dc"] = (torch.abs(0.28209479177387814 * dc + 0.5)
                           <= 1e-6).numpy()
    assert 0 < edge["features_dc"].sum() < edge["features_dc"].size
    for g in PARAM_GROUPS:
        off = ~edge[g]
        for got, want in ((getattr(tp, g), getattr(jp, g)),
                          (topt.mu[g], getattr(jopt.mu, g)),
                          (topt.nu[g], getattr(jopt.nu, g))):
            np.testing.assert_allclose(got.detach().numpy()[off],
                                       np.asarray(want)[off], rtol=0,
                                       atol=STEP_ATOL, err_msg=g)
        # on the edge: one Adam step at most
        np.testing.assert_allclose(getattr(tp, g).detach().numpy(),
                                   np.asarray(getattr(jp, g)), rtol=0,
                                   atol=float(lrs[g]) + STEP_ATOL, err_msg=g)

    grown = _argv(scene_dir, str(tmp_path / "grown"), "--iterations", 1,
                  "--dup_capacity", 2 * STARVED)
    (_, gp, _, gopt), text = _capture(lambda: t_train.main(grown))
    assert "overflow" not in text and gopt.step == 1
    for g in PARAM_GROUPS:
        assert torch.equal(getattr(gp, g), getattr(tp, g)), g
        assert torch.equal(gopt.mu[g], topt.mu[g]), g
        assert torch.equal(gopt.nu[g], topt.nu[g]), g


# the loop flags no other test holds against JAX: each case runs JAX's
# loop with the flag for 7 iterations, checkpoint at 6 (from checkpoint 3
# the rotation knife edge of test_torch_trainer.py's docstring still shows
# past FLAG_STEPS), then resumes both packages from it for iteration 7
# with the same --iterations, so that JAX's resumed run reuses its loop's
# compiled step (OptimizationParams, a static argument, holds
# ``iterations``); at the capacity of the retried test's second attempt,
# whose compiled parts JAX's loops reuse
LOOP_FLAGS = {"white_background": ["--white_background"],
              "train_test_exp": ["--train_test_exp"],
              "antialiasing": ["--antialiasing"],
              "sparse_adam": ["--optimizer_type", "sparse_adam"]}
FLAG_CHECKPOINT = 6
FLAG_STEPS = 5e-4       # learning rates, off the colour knife edge


@pytest.mark.parametrize("flag", list(LOOP_FLAGS))
def test_loop_flag_iterations_match_jax(scene_dir, tmp_path, flag):
    """One loop flag, one iteration: JAX's ``training`` writes checkpoint
    6; from it both packages' ``training`` run iteration 7. A whole loop
    with these flags drifts apart on the colour knife edge (ROADMAP §3),
    so the iteration starts from JAX's own state, as
    ``test_resume_across_packages`` does. Held: the step and ``alive``
    exactly; every parameter within ``FLAG_STEPS`` of its group's learning
    rate at that iteration of JAX's (1.2e-4 measured), but on the colour
    channels at the colour clamp's 0 in the checkpoint (the module's knife
    edge), where one learning rate more is allowed (0.51 measured); the
    moments within ``MOMENT_TOL`` of the group's largest |JAX| off that
    edge."""
    k = FLAG_CHECKPOINT
    extra = LOOP_FLAGS[flag] + ["--iterations", k + 1, "--dup_capacity",
                                2 * STARVED]
    root = tmp_path / "jax"
    _capture(lambda: j_train.training(j_train.build_parser().parse_args(
        _argv(scene_dir, str(root), "--checkpoint_iterations", k, *extra))))
    ck = str(root / f"chkpnt{k}.npz")
    argv = _argv(scene_dir, str(tmp_path / "port"), "--start_checkpoint", ck,
                 *extra)
    (scene, tp, _, topt), _ = _capture(lambda: t_train.main(argv))
    jargs = j_train.build_parser().parse_args(_argv(
        scene_dir, str(tmp_path / "jax_resumed"), "--start_checkpoint", ck,
        *extra))
    (_, jp, jaux, jopt), _ = _capture(lambda: j_train.training(jargs))
    assert topt.step == int(jopt.step) == k + 1
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jaux.alive))
    lrs = t_train.group_learning_rates(t_train.OptimizationParams(),
                                       k + 1, scene.cameras_extent)
    dc = np.load(ck)["params/features_dc"].astype(np.float64)
    for g in PARAM_GROUPS:
        want = np.asarray(getattr(jp, g))
        on = (np.abs(0.28209479177387814 * dc + 0.5) <= 1e-6
              if g == "features_dc" else np.zeros(want.shape, bool))
        steps = np.abs(getattr(tp, g).detach().numpy() - want) \
            / float(lrs[g])
        assert steps[~on].max(initial=0.0) <= FLAG_STEPS, (flag, k, g)
        assert steps[on].max(initial=0.0) <= 1 + FLAG_STEPS, (flag, k, g)
        for got, ref in ((topt.mu[g], getattr(jopt.mu, g)),
                         (topt.nu[g], getattr(jopt.nu, g))):
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                got.numpy()[~on], ref[~on], rtol=0,
                atol=MOMENT_TOL * np.abs(ref).max(initial=0.0),
                err_msg=f"{flag} {k} {g}")


def test_resume_with_train_test_exp_from_a_checkpoint_without_it(
        scene_dir, tmp_path):
    """A checkpoint written without ``--train_test_exp`` holds an exposure
    row per train view (7 here); with the flag the scene maps every view
    (8). The resumed run refuses before its first iteration, naming the
    flag and both counts (JAX's loop runs on, its gathers clamped:
    ROADMAP §3)."""
    model = str(tmp_path / "model")
    _capture(lambda: t_train.main(_argv(
        scene_dir, model, "--iterations", 2, "--checkpoint_iterations", 2)))
    ck = os.path.join(model, "chkpnt2.npz")
    assert np.load(ck)["params/exposure"].shape[0] == 7
    argv = _argv(scene_dir, str(tmp_path / "resumed"), "--start_checkpoint",
                 ck, "--iterations", 4, "--train_test_exp")
    with pytest.raises(ValueError, match=r"7 exposure rows .* maps 8 images "
                       r".*--train_test_exp"):
        _capture(lambda: t_train.main(argv))


def test_train_lm_main_adam_then_lm(scene_dir, tmp_path, monkeypatch):
    """Two Adam iterations, then two LM iterations through the hook: the
    windows are JAX's draws, the best validation loss falls, xyz stays
    (``mask_xyz``) and the final save is written."""
    windows, infos = [], []
    real_window, real_phase = t_train_lm.select_window, t_train_lm.lm_phase

    def window(*a, **k):
        windows.append(real_window(*a, **k))
        return windows[-1]

    def phase(scene, params, *a, **k):
        xyz = params.xyz.detach().clone()
        out = real_phase(scene, params, *a, **k)
        assert torch.equal(out[0].xyz, xyz)
        infos.append(out[1])
        return out

    monkeypatch.setattr(t_train_lm, "select_window", window)
    monkeypatch.setattr(t_train_lm, "lm_phase", phase)
    argv = _argv(scene_dir, str(tmp_path / "lm"), "--iterations", 4,
                 "--jvp_start", 3, "--num_images", 3, "--num_val_views", 6,
                 "--val_view_stride", 1)
    (scene, params, _, opt_state), text = _capture(
        lambda: t_train_lm.main(argv))
    rng = np.random.default_rng(0)
    n = len(scene.get_train_cameras())
    assert windows == [j_lm_window(n, 3, rng) for _ in range(2)]
    losses = [float(i["best_val_loss"]) for i in infos]
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
    assert "[ITER 3] LM window" in text and "[ITER 4] LM window" in text
    assert opt_state.step == 2          # Adam ran iterations 1 and 2 only
    assert os.path.exists(tmp_path / "lm" / "point_cloud" / "iteration_4"
                          / "point_cloud.ply")


def test_train_sgd_main_windows(scene_dir, tmp_path, monkeypatch):
    """``train_sgd.main``: each iteration one strided window of
    ``--num_images`` views, drawn as JAX draws them."""
    sizes = []
    real = t_train.loss_and_grads

    def step(params, cam, *a, **k):
        sizes.append(cam.batch_size)
        return real(params, cam, *a, **k)

    monkeypatch.setattr(t_train, "loss_and_grads", step)
    argv = _argv(scene_dir, str(tmp_path / "sgd"), "--iterations", 3,
                 "--num_images", 3)
    (_, params, _, opt_state), text = _capture(
        lambda: t_train_sgd.main(argv))
    assert sizes == [3, 3, 3] and opt_state.step == 3
    assert "SGD windows of 3" in text
    assert all(bool(torch.isfinite(getattr(params, g)).all())
               for g in PARAM_GROUPS)


def test_quiet_silences_the_run(scene_dir, tmp_path):
    argv = _argv(scene_dir, str(tmp_path / "quiet"), "--iterations", 2,
                 "--quiet")
    _, text = _capture(lambda: t_train.main(argv))
    # only main's own line before safe_state silences stdout
    assert text == f"Optimizing {tmp_path / 'quiet'}\n"


def test_safe_state_wraps_once():
    """A repeated ``safe_state`` wraps the stream under the wrapper (one
    stamp per line), seeds ``random`` and ``np.random``, and putting the
    caller's stream back undoes it."""
    saved, buf = sys.stdout, io.StringIO()
    sys.stdout = buf
    try:
        safe_state(seed=3)
        safe_state(seed=3)
        print("line")
        draws = (random.random(), np.random.rand())
        safe_state(silent=True)
        print("hidden")
    finally:
        sys.stdout = saved
    assert re.fullmatch(r"line \[\d\d/\d\d \d\d:\d\d:\d\d\]\n", buf.getvalue())
    random.seed(3)
    np.random.seed(3)
    assert draws == (random.random(), np.random.rand())


def test_entry_points_raise_naming_cuda_without_it(scene_dir, tmp_path,
                                                   monkeypatch):
    from gslm_tpu_torch.eval import metrics, render_sets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-s", scene_dir, "-m", str(tmp_path / "m"), "--iterations", "1",
            "--disable_viewer"]
    for main in (t_train.main, t_train_lm.main, t_train_sgd.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            _capture(lambda: main(argv))
    with pytest.raises(RuntimeError, match="CUDA"):
        render_sets.main(["-m", str(tmp_path / "m"), "-s", scene_dir])
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.main(["-m", str(tmp_path / "m")])
    with pytest.raises(ValueError, match="platform"):
        _capture(lambda: t_train.main(argv + ["--platform", "tpu"]))


def test_profiling_helpers(tmp_path):
    """``--profile_dir``'s Chrome trace, which holds the program's spans,
    the loop's timer and ``--detect_anomaly``."""
    import json

    from gslm_tpu_torch.utils import profiling
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("gslm.test"):
            torch.ones(64).cumsum(0)
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "gslm.test" for e in events)
    timer = profiling.IterTimer()
    assert timer.tick() >= 0.0 and timer.value_ms >= 0.0
    was = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
