"""gslm_tpu_torch's trainer over two gloo ranks (``train.main --mesh_data
2 --platform cpu``) against gslm_tpu's ``training --mesh_data 2`` on its
virtual CPU devices.

Both run ``tests/test_torch_trainer.py``'s command line (the 8-view
synthetic COLMAP scene, 14 iterations, density events after 5 and 10, an
opacity reset at 12, tests, a save and checkpoints) with a window of 2
views per Adam iteration, one per rank (JAX: one per device), drawn from
``default_rng(0)`` in both. The port's split noise is JAX's own draws
(``PRNGKey(0)`` split per event, as gslm_tpu/densify.py draws them).

Held: both ranks' final states bit for bit equal; ``alive`` and the Adam
step count equal to JAX's; parameters and moments within
``tests/test_torch_trainer.py::_assert_params``'s bounds (its knife-edge
exemptions, nothing widened); only rank 0 wrote the model directory, and
it holds JAX's files. ``train_sgd.main --mesh_data 2 --num_images 5``
(windows cut to 4 views, 2 per rank) against the port's single process
with ``--num_images 4`` (the same windows from the same draws): the
parameters within 1e-5 where the single run's first moment exceeds 1e-3
of its group's largest (tests/test_torch_train.py's Adam knife edge),
the moments within 1e-2 of their group's largest
(``tests/test_torch_trainer.py``'s ``MOMENT_TOL``)."""

import sys
import types

import numpy as np
import pytest
import torch

import jax

from gslm_tpu_torch import train_sgd
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from test_torch_trainer import (ITERS, LINEAGE_ROWS, _argv, _assert_params,
                                _files, _run_jax)
from tests.synthetic_scene import build_colmap_scene
from torch_ranks import run_ranks, trainer_worker

CAPACITY = 256


def _jax_draws(events: int) -> list:
    """JAX's split noise of the first ``events`` density events."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(events):
        key, sub = jax.random.split(key)
        out.append(tuple(np.asarray(jax.random.normal(k, (CAPACITY, 3)))
                         for k in jax.random.split(sub)))
    return out


@pytest.fixture(scope="module")
def scene_src(tmp_path_factory):
    return build_colmap_scene(str(tmp_path_factory.mktemp("scene") / "src"),
                              n_views=8)


@pytest.fixture(scope="module")
def mesh_runs(scene_src, tmp_path_factory):
    src = scene_src
    root = tmp_path_factory.mktemp("mesh")
    mp = pytest.MonkeyPatch()
    saved = sys.stdout
    try:
        jrun = _run_jax(mp, _argv(src, str(root / "jax"), mesh_data=2),
                        rec=False)
    finally:
        sys.stdout = saved
        mp.undo()
    ranks = run_ranks(trainer_worker, 2,
                      _argv(src, str(root / "port"), mesh_data=2),
                      _jax_draws(4))
    return root, jrun, ranks


def test_mesh_trainer_ranks_agree_and_only_rank0_writes(mesh_runs):
    root, _, ranks = mesh_runs
    a, b = ranks[0]["state"], ranks[1]["state"]
    for k, v in a.items():
        assert (torch.equal(b[k], v) if torch.is_tensor(v) else b[k] == v), k
    assert a["step"] == ITERS
    assert ranks[1]["writes"] == []
    assert sorted(set(ranks[0]["writes"])) == [
        "save", "save_cfg_args", "save_checkpoint", "store_point_cloud"]
    assert _files(root / "port") == _files(root / "jax")
    assert "chkpnt7.npz" in _files(root / "port")


def test_mesh_trainer_matches_jax(mesh_runs):
    _, jrun, ranks = mesh_runs
    st = ranks[0]["state"]
    params = types.SimpleNamespace(alive=st["alive"],
                                   **{g: st[g] for g in PARAM_GROUPS})
    opt = types.SimpleNamespace(mu={g: st[f"mu/{g}"] for g in PARAM_GROUPS},
                                nu={g: st[f"nu/{g}"] for g in PARAM_GROUPS})
    scene = types.SimpleNamespace(cameras_extent=ranks[0]["extent"])
    assert st["step"] == int(jrun[4].step) == ITERS
    _assert_params(jrun, (None, scene, params, None, opt),
                   lineage_rows=LINEAGE_ROWS)


def test_mesh_sgd_windows_match_single_process(scene_src, tmp_path):
    """``train_sgd``'s windows over two ranks: ``--num_images 5`` cut to a
    multiple of the ranks, 4 views, 2 per rank."""
    flags = dict(iterations=4, densify_from_iter=100, test_iterations=[4],
                 save_iterations=[4], checkpoint_iterations=None)
    ranks = run_ranks(trainer_worker, 2,
                      _argv(scene_src, str(tmp_path / "mesh"), mesh_data=2,
                            num_images=5, **flags), [], "train_sgd")
    saved = sys.stdout
    try:
        _, tp, _, topt = train_sgd.main(_argv(
            scene_src, str(tmp_path / "single"), num_images=4, **flags))
    finally:
        sys.stdout = saved
    a, b = ranks[0]["state"], ranks[1]["state"]
    for k, v in a.items():
        assert (torch.equal(b[k], v) if torch.is_tensor(v) else b[k] == v), k
    assert a["step"] == topt.step == 4
    assert torch.equal(a["alive"], tp.alive)
    for g in PARAM_GROUPS:
        mu = topt.mu[g].abs()
        sure = mu > 1e-3 * float(mu.max())
        np.testing.assert_allclose(a[g][sure].numpy(),
                                   getattr(tp, g).detach()[sure].numpy(),
                                   rtol=0, atol=1e-5, err_msg=g)
        for m in ("mu", "nu"):
            want = getattr(topt, m)[g]
            np.testing.assert_allclose(
                a[f"{m}/{g}"].numpy(), want.numpy(), rtol=0,
                atol=1e-2 * float(want.abs().max()), err_msg=f"{m}/{g}")
