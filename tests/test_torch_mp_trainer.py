"""gslm_tpu_torch's trainer with a model axis: ``train.main --mesh_data 2
--mesh_model 2 --platform cpu`` (4 gloo ranks, ``tests/torch_ranks.py``,
spawned once) against gslm_tpu's ``training --mesh_data 2 --mesh_model 2``
on its (2, 2) virtual CPU mesh, then ``train_lm.main`` from the mesh's
checkpoint for one LM iteration, against the port's single process from
the same checkpoint.

The scene and command line are ``tests/test_torch_trainer.py``'s (the
8-view synthetic COLMAP scene, 14 Adam iterations, density events after 5
and 10, an opacity reset at 12, tests and checkpoints at 4, 7 and 14);
each Adam iteration draws a window of 2 views from ``default_rng(0)``, one
per data row, in both; every rank of a data row renders its tile-row band
from its 128 of the 256 rows, as every JAX device does. The port's split
noise is JAX's own per-shard draws (``PRNGKey(0)`` split per event, shard
m's from ``fold_in(sub, m)``, as gslm_tpu/parallel/steps.py's
``make_mp_densify`` draws them), shard-major.

Held (JAX's ``test_mp_mode_training_runs`` asks PSNR above 10):
- the ranks of each model column (the two data rows) bit for bit equal,
  after the Adam loop and after the LM iteration;
- the gathered checkpoints of iteration 4 (before the first density
  event) and 14 (after both events, the rebalance and the opacity reset)
  against JAX's, and the ranks' shards against JAX's final sharded state,
  within ``tests/test_torch_trainer.py::_assert_params``' bounds (its
  knife-edge exemptions, nothing widened);
- each density event's counts, the rebalanced rows included, equal JAX's;
- the PSNR of the test evaluations above 10;
- the LM iteration's best val loss within rtol 1e-4 of the single
  process's from the same (the mesh's gathered) checkpoint, its alpha
  equal."""

import sys
import types

import numpy as np
import pytest
import torch

import jax

import gslm_tpu.parallel as j_parallel
from gslm_tpu_torch import train_lm, train_sgd
from gslm_tpu_torch.checkpoint import load_checkpoint
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from test_torch_trainer import (ITERS, LINEAGE_ROWS, _argv, _assert_params,
                                _restore_stdout, _run_jax)
from tests.synthetic_scene import build_colmap_scene
from torch_ranks import mp_trainer_worker, run_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

CAPACITY = 256
N_MODEL = 2
LM_FLAGS = dict(iterations=ITERS + 1, jvp_start=ITERS + 1, num_images=2,
                num_val_views=4, micro_batch=2, cg_max_iter=1,
                line_search_steps=1, test_iterations=[ITERS + 1],
                save_iterations=[ITERS + 1], checkpoint_iterations=None,
                densify_from_iter=100)


def _jax_mp_draws(events: int) -> list:
    """JAX's per-shard split noise of the first ``events`` density events
    on a model axis of 2, shard-major: the whole-capacity pairs the port
    takes."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(events):
        key, sub = jax.random.split(key)
        pair = ([], [])
        for m in range(N_MODEL):
            for i, k in enumerate(jax.random.split(
                    jax.random.fold_in(sub, m))):
                pair[i].append(np.asarray(jax.random.normal(
                    k, (CAPACITY // N_MODEL, 3))))
        out.append(tuple(np.concatenate(p) for p in pair))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_trainer")
    src = build_colmap_scene(str(root / "src"), n_views=8)
    flags = dict(checkpoint_iterations=[4, 7, ITERS])
    ranks = run_ranks(
        mp_trainer_worker, 4,
        _argv(src, str(root / "mesh"), mesh_data=2, mesh_model=N_MODEL,
              **flags),
        _jax_mp_draws(2),
        _argv(src, str(root / "mesh_lm"), mesh_data=2, mesh_model=N_MODEL,
              start_checkpoint=str(root / "mesh" / f"chkpnt{ITERS}.npz"),
              **LM_FLAGS))

    events, lm_infos = [], []
    make_densify = j_parallel.make_mp_densify
    lm_phase = train_lm.lm_phase
    mp = pytest.MonkeyPatch()

    def densify_factory(*a, **k):
        step = make_densify(*a, **k)

        def recorded(*a, **k):
            out = step(*a, **k)
            events.append({n: int(v) for n, v in out[3].items()})
            return out
        return recorded

    def lm_recorded(*a, **k):
        out = lm_phase(*a, **k)
        lm_infos.append({n: float(out[1][n]) for n in ("best_val_loss",
                                                       "best_alpha")})
        return out

    saved = sys.stdout
    try:
        mp.setattr(j_parallel, "make_mp_densify", densify_factory)
        mp.setattr(train_lm, "lm_phase", lm_recorded)
        jrun = _run_jax(mp, _argv(src, str(root / "jax"), mesh_data=2,
                                  mesh_model=N_MODEL, **flags), rec=False)
        train_sgd.main(_argv(src, str(root / "single"), num_images=2,
                             iterations=4, test_iterations=[4],
                             save_iterations=[4], checkpoint_iterations=[4]))
        train_lm.main(_argv(src, str(root / "single_lm"),
                            start_checkpoint=str(root / "mesh"
                                                 / f"chkpnt{ITERS}.npz"),
                            **LM_FLAGS))
    finally:
        _restore_stdout(saved)
        mp.undo()
    return root, ranks, jrun, events, lm_infos


def _as_run(path):
    """A checkpoint as ``_assert_params``' run tuple (the port's side)."""
    p, aux, opt, _, _ = load_checkpoint(str(path), device="cpu")
    return p, aux, opt


def _as_ref(path):
    """A checkpoint as ``_assert_params``' reference run tuple (JAX's
    side): numpy parameters, ``alive`` and moments."""
    p, _, opt = _as_run(path)
    return (None, None,
            types.SimpleNamespace(**{g: getattr(p, g).detach().numpy()
                                     for g in PARAM_GROUPS}),
            types.SimpleNamespace(alive=p.alive.numpy()),
            types.SimpleNamespace(**{m: types.SimpleNamespace(
                **{g: getattr(opt, m)[g].numpy() for g in PARAM_GROUPS})
                for m in ("mu", "nu")}), opt.step)


def _scene(root):
    return types.SimpleNamespace(cameras_extent=float(
        np.load(root / "mesh" / "chkpnt4.npz")["spatial_lr_scale"]))


def test_mp_trainer_ranks_agree(runs):
    _, ranks, _, _, _ = runs
    for key in ("adam", "lm"):
        for r in (2, 3):
            for k, v in ranks[r - 2][key].items():
                assert (torch.equal(ranks[r][key][k], v)
                        if torch.is_tensor(v) else ranks[r][key][k] == v), \
                    (key, k, r)
    assert ranks[0]["adam"]["step"] == ITERS
    assert int(ranks[0]["adam"]["alive"].shape[0]) == CAPACITY // 2


def test_mp_trainer_matches_single_before_densify(runs):
    """The mesh's gathered checkpoint of iteration 4 against the port's
    single process (``train_sgd --num_images 2``, the same windows)."""
    root = runs[0]
    ref = _as_ref(root / "single" / "chkpnt4.npz")
    mp_, _, mopt = _as_run(root / "mesh" / "chkpnt4.npz")
    assert ref[5] == mopt.step == 4
    _assert_params(ref[:5], (None, _scene(root), mp_, None, mopt))


def test_mp_trainer_matches_jax_mesh_training(runs):
    """The mesh against JAX's ``training`` on its (2, 2) mesh: the gathered
    checkpoints of iterations 4 and 14, and the ranks' final shards (data
    row 0's, concatenated) against JAX's final sharded state."""
    root, ranks, jrun, _, _ = runs
    scene = _scene(root)
    ref = _as_ref(root / "jax" / "chkpnt4.npz")
    mp_, _, mopt = _as_run(root / "mesh" / "chkpnt4.npz")
    assert ref[5] == mopt.step == 4
    _assert_params(ref[:5], (None, scene, mp_, None, mopt))
    mp_, _, mopt = _as_run(root / "mesh" / f"chkpnt{ITERS}.npz")
    assert mopt.step == int(jrun[4].step) == ITERS
    _assert_params(jrun, (None, scene, mp_, None, mopt),
                   lineage_rows=LINEAGE_ROWS)
    shards = [ranks[m]["adam"] for m in range(N_MODEL)]
    st = {k: torch.cat([o[k] for o in shards]) for k in shards[0]
          if torch.is_tensor(shards[0][k]) and k != "exposure"
          and not k.endswith("/exposure")}
    params = types.SimpleNamespace(alive=st["alive"], exposure=shards[0][
        "exposure"], **{g: st[g] for g in PARAM_GROUPS if g != "exposure"})
    opt = types.SimpleNamespace(**{m: {g: shards[0][f"{m}/{g}"]
                                       if g == "exposure" else st[f"{m}/{g}"]
                                       for g in PARAM_GROUPS}
                                   for m in ("mu", "nu")})
    _assert_params(jrun, (None, scene, params, None, opt),
                   lineage_rows=LINEAGE_ROWS)


def test_mp_trainer_density_events_and_psnr(runs):
    """Each density event's counts, the rebalanced rows included, equal
    JAX's mesh training's."""
    _, ranks, _, events, _ = runs
    got = ranks[0]["events"]
    assert len(got) == len(events) == 2
    for g, w in zip(got, events):
        assert g == w, (got, events)
    # every rank's events agree (the counts are summed over the model axis)
    for o in ranks[1:]:
        assert o["events"] == got
    evals = ranks[0]["evals"][:4]     # the Adam loop's train and test
    assert len(evals) == 4            # views at 7 and 14
    assert all(np.isfinite(e["psnr"]) and e["psnr"] > 10.0 for e in evals)
    for o in ranks[1:]:
        assert o["evals"] == []       # only rank 0 evaluates


def test_mp_trainer_lm_iteration_matches_single(runs):
    _, ranks, _, _, lm_infos = runs
    got = ranks[0]["lm_infos"]
    assert len(got) == len(lm_infos) == 1
    np.testing.assert_allclose(got[0]["best_val_loss"],
                               lm_infos[0]["best_val_loss"], rtol=1e-4)
    assert got[0]["best_alpha"] == lm_infos[0]["best_alpha"]
    for o in ranks[1:]:
        assert o["lm_infos"] == got
