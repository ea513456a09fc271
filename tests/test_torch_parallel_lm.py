"""gslm_tpu_torch.parallel's data-parallel LM step and ``lm_phase(mesh=)``
against the port's single process and gslm_tpu's LM step.

Two gloo ranks on the CPU (``tests/torch_ranks.py``). JAX's data-parallel
LM tests are marked slow and its single-device step equals them to 1e-5
(tests/test_parallel.py:214-232, 357-395), so its reference here is its
single-device ``lm_outer_step`` (XLA tile pipeline on the CPU); the port
renders through the plain versions of kernels A, C and E. The scene is
JAX's ``tiny`` fixture, the step JAX's: 1 CG iteration, 3 line-search
step lengths.

Tolerances, JAX's own: ``best_val_loss`` within rtol 1e-4, xyz within
1e-5; the port's other groups within 1e-5 of its single process and, like
tests/test_torch_lm.py, within rtol 1e-4 (atol 1e-4·max) of JAX's; both
ranks bit for bit equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu import config as j_config
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.train_lm import lm_outer_step as j_lm_outer_step
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.config import LMParams
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.renderer import overflow_probe
from gslm_tpu_torch.train_lm import lm_outer_step, lm_phase
from torch_ranks import (LM, LM_PADDED, RCFG, STEP_KW, TINY, info_dict,
                         lm_phase_worker, lm_worker, run_ranks, state_dict,
                         tiny_scene)

PAD = [0, 1, 2, 0]
LM_PHASE = dict(num_images=2, micro_batch=2, num_val_views=4,
                val_view_stride=1, line_search_steps=1, cg_max_iter=1)


@pytest.fixture(scope="module")
def lm_runs():
    return run_ranks(lm_worker, 2)


def _single(lm, idx):
    params, _, _, cams = tiny_scene()
    cams = cams.take(idx)
    new, info = lm_outer_step(params, params.alive, cams, cams, torch.zeros(3),
                              rcfg=RCFG, lm=lm, **STEP_KW)
    return state_dict(new), info_dict(info)


def _jax(lm, idx):
    jp, jaux = j_random_gaussians(np.random.default_rng(TINY["seed"]),
                                  n=TINY["n"], capacity=TINY["capacity"],
                                  num_images=TINY["views"])
    jcams = jax.tree.map(lambda x: x[jnp.asarray(idx)],
                         j_ring_camera_batch(TINY["views"], *TINY["hw"]))
    jlm = j_config.LMParams(**{k: getattr(lm, k) for k in (
        "cg_max_iter", "cg_restart_iter", "line_search_steps",
        "num_val_views", "micro_batch")})
    new, info = j_lm_outer_step(jp, jaux.alive, jcams, jcams, jnp.zeros(3),
                                rcfg=JRasterConfig(dup_capacity=1 << 12),
                                lm=jlm, **STEP_KW)
    return new, info


def _ranks_equal(outs, *keys):
    for key in keys:
        for k, v in outs[0][key].items():
            assert torch.equal(outs[1][key][k], v), (key, k)


def _held_to_single(got, got_info, want, want_info):
    np.testing.assert_allclose(float(got_info["best_val_loss"]),
                               float(want_info["best_val_loss"]), rtol=1e-4)
    assert float(got_info["best_alpha"]) == float(want_info["best_alpha"])
    for g in PARAM_GROUPS:
        np.testing.assert_allclose(got[g].numpy(), want[g].numpy(), rtol=0,
                                   atol=1e-5, err_msg=g)


def _held_to_jax(got, got_info, jnew, jinfo):
    np.testing.assert_allclose(float(got_info["best_val_loss"]),
                               float(jinfo["best_val_loss"]), rtol=1e-4)
    assert float(got_info["best_alpha"]) == float(jinfo["best_alpha"])
    np.testing.assert_allclose(got["xyz"].numpy(), np.asarray(jnew.xyz),
                               rtol=0, atol=1e-5)
    for g in PARAM_GROUPS:
        want = np.asarray(getattr(jnew, g))
        np.testing.assert_allclose(got[g].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=g)


def test_dp_lm_step_matches_single(lm_runs):
    _ranks_equal(lm_runs, "dp", "dp_info")
    _held_to_single(lm_runs[0]["dp"], lm_runs[0]["dp_info"],
                    *_single(LM, [0, 1, 2, 3]))


def test_dp_lm_step_matches_jax(lm_runs):
    _held_to_jax(lm_runs[0]["dp"], lm_runs[0]["dp_info"],
                 *_jax(LM, [0, 1, 2, 3]))


def test_dp_lm_step_with_padded_window(lm_runs):
    """A 3-view window (and val set) padded to 4 with a zero-weight
    duplicate of view 0, 2 views per rank, equals the 3-view single step
    (JAX's tests/test_parallel.py:357-395)."""
    _ranks_equal(lm_runs, "padded", "padded_info")
    got, got_info = lm_runs[0]["padded"], lm_runs[0]["padded_info"]
    _held_to_single(got, got_info, *_single(LM_PADDED, PAD[:3]))
    _held_to_jax(got, got_info, *_jax(LM_PADDED, PAD[:3]))


def test_sharded_lm_step_equals_dp(lm_runs):
    """At a model axis of 1 the GSPMD step's counterpart is the
    data-parallel step, bit for bit."""
    for o in lm_runs:
        for k, v in o["dp"].items():
            assert torch.equal(o["sharded"][k], v), k
        for k, v in o["dp_info"].items():
            assert torch.equal(o["sharded_info"][k], v), k


def _mesh_need(params) -> int:
    """The most records of any render unit of the 2-rank run of
    ``LM_PHASE`` at ``params``: each rank's 1-view window slice and its
    2-view val chunk (counts of the port's probe on the single process)."""
    from gslm_tpu_torch.train_lm import select_window, val_indices
    lm = LMParams(**LM_PHASE)
    win = select_window(TINY["views"], lm.num_images,
                        np.random.default_rng(0))
    vidx = val_indices(TINY["views"], lm)
    out = overflow_probe(params, tiny_scene()[3], config=RasterConfig(),
                         per_view=True)
    na, nl = out["n_aabb"].numpy(), out["n_live"].numpy()
    units = [[v] for v in win] + [vidx[:2], vidx[2:]]
    return max(max(int(na[u].sum()), int(nl[u].sum())) for u in units)


def test_lm_phase_on_a_mesh():
    """``lm_phase(mesh=)`` on 2 ranks: at roomy capacities it equals the
    single process's ``lm_phase`` from the same seed; at a quarter of the
    largest render unit both ranks grow to the same capacities, exactly
    the doublings that the units of the start and of the accepted step
    need (an overflow-free step does not depend on the capacities), and
    finish."""
    params, _, _, cams = tiny_scene()
    roomy, starved = 1 << 12, _mesh_need(params) // 4
    outs = run_ranks(lm_phase_worker, 2, LM_PHASE, [roomy, starved])
    for cap in (roomy, starved):
        a, b = outs[0][cap], outs[1][cap]
        assert (a["dup"], a["live"]) == (b["dup"], b["live"])
        for part in ("state", "info"):
            for k, v in a[part].items():
                assert torch.equal(b[part][k], v), (cap, part, k)
        assert np.isfinite(float(a["info"]["best_val_loss"]))
    assert outs[0][roomy]["dup"] == roomy
    stepped = params_from_numpy(
        {g: outs[0][starved]["state"][g].numpy() for g in PARAM_GROUPS}, 3,
        alive=params.alive.numpy(), device="cpu")
    need = max(_mesh_need(params), _mesh_need(stepped))
    want = starved
    while want < need:
        want *= 2
    assert want > starved
    assert outs[0][starved]["dup"] == outs[0][starved]["live"] == want
    new, info, grown = lm_phase(None, params, None, cams,
                                RasterConfig(dup_capacity=roomy,
                                             live_capacity=roomy),
                                torch.zeros(3), LMParams(**LM_PHASE), 0,
                                np.random.default_rng(0), False, 0.2, 3,
                                verbose=False)
    assert grown.dup_capacity == roomy
    _held_to_single(outs[0][roomy]["state"], outs[0][roomy]["info"],
                    state_dict(new), info_dict(info))
