"""gslm_tpu_torch's density control and checkpoints (densify.py,
optim.zero_state_rows / zero_state_group, checkpoint.py) against gslm_tpu
on the same numpy inputs.

``densify_and_prune`` gets JAX's own draws: the test splits JAX's key as
JAX does and passes ``normal(k1, (C, 3))`` and ``normal(k2, (C, 3))`` to
the port. Tolerances: ``alive``, the ``info`` counts and the Adam moments
exact, the parameters to 1e-6 absolute (a child's offset is a rotated,
scaled noise vector that the two libraries sum in their own order); the
moment zeroing, ``reset_opacity`` and checkpoints exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu.checkpoint import load_checkpoint as j_load_checkpoint
from gslm_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from gslm_tpu.densify import densify_and_prune as j_densify_and_prune
from gslm_tpu.densify import reset_opacity as j_reset_opacity
from gslm_tpu.models.gaussians import GaussianAux as JGaussianAux
from gslm_tpu.optim import AdamState as JAdamState
from gslm_tpu.optim import zero_state_group as j_zero_state_group
from gslm_tpu.optim import zero_state_rows as j_zero_state_rows
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from gslm_tpu_torch.densify import densify_and_prune, reset_opacity
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                             params_from_numpy)
from gslm_tpu_torch.optim import AdamState, zero_state_group, zero_state_rows
from gslm_tpu_torch.utils.graphics import qvec2rotmat
from torch_threads import one_thread  # noqa: F401 (autouse)

AUX = ("max_radii2d", "xyz_gradient_accum", "denom")


def _state(seed, capacity=512, n=300, extent=3.0, screen=0.0,
           grad_scale=1.0):
    """One random training state as numpy arrays: the seven groups,
    ``alive``, the statistics, Adam moments and the thresholds."""
    rng = np.random.default_rng(seed)
    jp, jaux = j_random_gaussians(rng, n=n, capacity=capacity,
                                  scale_range=(-4.0, -1.0))
    groups = {g: np.array(getattr(jp, g)) for g in PARAM_GROUPS}
    groups["opacity"][:n] = rng.normal(-1.0, 3.0, (n, 1)).astype(np.float32)
    stats = {"max_radii2d": (rng.random(capacity) * 30).astype(np.float32),
             "xyz_gradient_accum": (rng.random(capacity) * 4e-4
                                    * grad_scale).astype(np.float32),
             "denom": rng.integers(0, 3, capacity).astype(np.float32)}
    moments = {m: {g: rng.normal(size=v.shape).astype(np.float32)
                   for g, v in groups.items()} for m in ("mu", "nu")}
    return dict(groups=groups, alive=np.array(jaux.alive), stats=stats,
                moments=moments, step=7,
                thresholds=(0.0002, 0.005, extent, screen, 0.01))


def _jax(s):
    p = j_random_gaussians(np.random.default_rng(0), n=1,
                           capacity=1)[0].replace(
        **{g: jnp.asarray(v) for g, v in s["groups"].items()})
    aux = JGaussianAux(alive=jnp.asarray(s["alive"]),
                       **{k: jnp.asarray(v) for k, v in s["stats"].items()})
    opt = JAdamState(**{m: p.replace(**{g: jnp.asarray(v) for g, v in
                                        s["moments"][m].items()})
                        for m in ("mu", "nu")}, step=jnp.int32(s["step"]))
    return p, aux, opt


def _port(s):
    p = params_from_numpy(s["groups"], 3, alive=s["alive"], device="cpu")
    aux = GaussianAux(**{k: torch.tensor(v) for k, v in s["stats"].items()})
    opt = AdamState(**{m: {g: torch.tensor(v) for g, v in
                           s["moments"][m].items()} for m in ("mu", "nu")},
                    step=s["step"])
    return p, aux, opt


def _jax_noise(key, capacity):
    k1, k2 = jax.random.split(key)
    return tuple(torch.tensor(np.asarray(jax.random.normal(k, (capacity, 3))))
                 for k in (k1, k2))


def _compare(p, opt, jp, jopt, alive, params_atol=1e-6, rows=slice(None)):
    np.testing.assert_array_equal(p.alive.numpy()[rows],
                                  np.asarray(alive)[rows])
    for g in PARAM_GROUPS:
        np.testing.assert_allclose(getattr(p, g).detach().numpy()[rows],
                                   np.asarray(getattr(jp, g))[rows], rtol=0,
                                   atol=params_atol, err_msg=g)
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(opt, m)[g].numpy()[rows],
                np.asarray(getattr(getattr(jopt, m), g))[rows],
                err_msg=f"{m}/{g}")


CASES = {
    # scales lie in [e^-4, e^-1]; extent 40: every hot Gaussian is small
    # (max scale <= 0.01 · 40)
    "clone-only": dict(seed=0, extent=40.0),
    # extent 0.1: every hot Gaussian is large
    "split-only": dict(seed=1, extent=0.1),
    "clone-and-split": dict(seed=2, extent=10.0),
    # 300 live in 320 slots: most requests find no free slot
    "starved": dict(seed=3, capacity=320),
    "screen-size-prune": dict(seed=4, screen=20.0),
    "nothing-hot": dict(seed=5, grad_scale=0.3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_densify_and_prune_matches_jax(case):
    s = _state(**CASES[case])
    key = jax.random.PRNGKey(CASES[case]["seed"])
    jp, jaux, jopt, jinfo = j_densify_and_prune(
        *_jax(s), key, *(jnp.float32(t) for t in s["thresholds"]))
    p, aux, opt = _port(s)
    p2, aux2, opt2, info = densify_and_prune(
        p, aux, opt, _jax_noise(key, p.capacity), *s["thresholds"])
    assert p2 is p and opt2 is opt
    assert all(v.ndim == 0 for v in info.values())
    got = {k: int(v) for k, v in info.items()}
    assert got == {k: int(v) for k, v in jinfo.items()}
    if case == "clone-only":
        assert got["n_cloned"] > 0 and got["n_split"] == 0
    elif case == "split-only":
        assert got["n_split"] > 0 and got["n_cloned"] == 0
    elif case == "clone-and-split":
        assert got["n_split"] > 0 and got["n_cloned"] > 0
    elif case == "starved":
        assert got["n_dropped"] > 0
    elif case == "screen-size-prune":
        assert got["n_pruned"] > int(np.sum(
            s["alive"] & (1 / (1 + np.exp(-s["groups"]["opacity"][:, 0]))
                          < 0.005)))
    else:
        assert got["n_cloned"] + got["n_split"] == 0
    _compare(p, opt, jp, jopt, jaux.alive)
    for k in AUX:
        assert not torch.any(getattr(aux2, k)) and not np.any(
            np.asarray(getattr(jaux, k)))


def test_densify_last_row_split_parent():
    """A split parent in the last slot (C-1). JAX marks the split parents
    with ``.at[src_c].set(...)``, where every dropped request is clamped to
    C-1 as well, so that row's flag is a scatter with duplicate indices
    (unspecified in JAX; on the CPU the dropped requests' False wins) and
    the parent keeps its place beside its second child. The port flags the
    parents by their rank among the requests: the last row becomes its
    first child like any other. Every other row matches JAX."""
    s = _state(seed=6)
    c = 512
    s["alive"][-1] = True
    s["stats"]["xyz_gradient_accum"][-1] = 1.0
    s["stats"]["denom"][-1] = 1.0
    s["groups"]["scaling"][-1] = 0.0
    s["groups"]["opacity"][-1] = 5.0
    key = jax.random.PRNGKey(6)
    jp, jaux, jopt, jinfo = j_densify_and_prune(
        *_jax(s), key, *(jnp.float32(t) for t in s["thresholds"]))
    p, aux, opt = _port(s)
    noise1, noise2 = _jax_noise(key, c)
    _, _, _, info = densify_and_prune(p, aux, opt, (noise1, noise2),
                                      *s["thresholds"])
    assert {k: int(v) for k, v in info.items()} == {
        k: int(v) for k, v in jinfo.items()}
    _compare(p, opt, jp, jopt, jaux.alive, rows=slice(0, c - 1))
    parent = s["groups"]["xyz"][-1]
    np.testing.assert_array_equal(np.asarray(jp.xyz)[-1], parent)
    # the port: child 1 = parent + R(q) · noise1 (its scales are exp(0))
    q = s["groups"]["rotation"][-1].astype(np.float64)
    child1 = parent + qvec2rotmat(q / np.linalg.norm(q)) @ noise1[-1].numpy()
    np.testing.assert_allclose(p.xyz[-1].detach().numpy(), child1, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(p.scaling[-1].detach().numpy(), np.full(3, -np.log(
        1.6)), rtol=0, atol=1e-6)
    assert bool(p.alive[-1])
    for m in ("mu", "nu"):
        for g in PARAM_GROUPS[:-1]:
            assert not torch.any(getattr(opt, m)[g][-1]), (m, g)


@pytest.mark.parametrize("what", ["rows", "exposure-rows", "group"])
def test_zero_state(what):
    s = _state(seed=7)
    _, _, jopt = _jax(s)
    _, _, opt = _port(s)
    if what == "group":
        jopt = j_zero_state_group(jopt, "opacity")
        assert zero_state_group(opt, "opacity") is opt
    else:
        rows = np.random.default_rng(8).random(512) < 0.3
        if what == "rows":
            jopt = j_zero_state_rows(jopt, jnp.asarray(rows))
            assert zero_state_rows(opt, torch.tensor(rows)) is opt
        else:
            # exposure's leading axis is the image count: zero its first
            # four rows of a four-image model
            rows = rows[:4]
            jopt = j_zero_state_rows(jopt, jnp.asarray(rows), groups=(
                "exposure",))
            zero_state_rows(opt, torch.tensor(rows), groups=("exposure",))
    for m in ("mu", "nu"):
        for g in PARAM_GROUPS:
            np.testing.assert_array_equal(
                getattr(opt, m)[g].numpy(),
                np.asarray(getattr(getattr(jopt, m), g)), err_msg=g)


def test_reset_opacity():
    s = _state(seed=9)
    jp, _, jopt = _jax(s)
    jp, jopt = j_reset_opacity(jp, jopt)
    p, _, opt = _port(s)
    assert reset_opacity(p, opt) == (p, opt)
    _compare(p, opt, jp, jopt, s["alive"], params_atol=0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_interchange(tmp_path, writer):
    """A checkpoint written by either package loads in both, every array
    equal; ``aux/alive`` is the port's ``params.alive``."""
    s = _state(seed=10)
    path = str(tmp_path / "ck.npz")
    if writer == "jax":
        j_save_checkpoint(path, *_jax(s), 1234, 2.5)
    else:
        save_checkpoint(path, *_port(s), 1234, 2.5)
    keys = sorted(np.load(path).files)
    assert "aux/alive" in keys and "opt/step" in keys
    p, aux, opt, it, lr_scale = load_checkpoint(path, device="cpu")
    jp, jaux, jopt, jit, jlr_scale = j_load_checkpoint(path)
    assert (it, lr_scale, opt.step) == (jit, jlr_scale, int(jopt.step))
    assert (it, lr_scale, opt.step) == (1234, 2.5, s["step"])
    assert p.sh_degree == jp.sh_degree == 3
    _compare(p, opt, jp, jopt, jaux.alive, params_atol=0)
    np.testing.assert_array_equal(p.alive.numpy(), s["alive"])
    for k in AUX:
        np.testing.assert_array_equal(getattr(aux, k).numpy(),
                                      np.asarray(getattr(jaux, k)))
        np.testing.assert_array_equal(getattr(aux, k).numpy(), s["stats"][k])
    for g in PARAM_GROUPS:
        np.testing.assert_array_equal(getattr(p, g).detach().numpy(),
                                      s["groups"][g])
    # the other package's writer gives the same keys, dtypes and shapes
    other = str(tmp_path / "other.npz")
    if writer == "jax":
        save_checkpoint(other, p, aux, opt, it, lr_scale)
    else:
        j_save_checkpoint(other, jp, jaux, jopt, jit, jlr_scale)
    a, b = np.load(path), np.load(other)
    assert a.files == b.files
    for k in a.files:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
