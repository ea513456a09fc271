"""gslm_tpu_torch.parallel's model axis: the mesh, the band raster with both
exchanges, the band probe, the sharded checkpoint, densification per
shard and the rebalance, against the port's single process and gslm_tpu.

The port's ranks are 4 gloo processes on the CPU (``tests/torch_ranks.py``,
spawned once for the module: a (2, 2) mesh, and a (1, 4) mesh of the same
ranks for the rebalance); JAX's references run in this process on its 8
virtual CPU devices (tests/conftest.py), through its XLA tile pipeline,
the port through the plain versions of kernels A and B. The scene is JAX's
``tiny`` fixture (tests/test_parallel.py): 48 Gaussians in 256 slots, 4
ring views at 32x32.

Tolerances, JAX's own (tests/test_parallel.py): images and invdepth within
1e-6 (the port's bands concatenate to its single process's render bit for
bit on the CPU), the densify counts equal, the rebalanced shards' rows
equal. JAX's rebalance test runs a (2, 4) mesh; rebalance lives on the
model axis alone, so the port's runs (1, 4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from gslm_tpu.densify import densify_and_prune as j_densify_and_prune
from gslm_tpu.optim import init_adam as j_init_adam
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.parallel import make_mesh as j_make_mesh
from gslm_tpu.parallel import make_mp_densify as j_make_mp_densify
from gslm_tpu.parallel.model_raster import exchange_bytes as j_exchange_bytes
from gslm_tpu.parallel.model_raster import mp_rebalance as j_mp_rebalance
from gslm_tpu.parallel.model_raster import \
    mp_render_views as j_mp_render_views
from gslm_tpu.parallel.steps import _mp_specs
from gslm_tpu.renderer import overflow_probe as j_overflow_probe
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, GaussianParams
from gslm_tpu_torch.parallel import make_mesh
from gslm_tpu_torch.parallel.model_raster import exchange_bytes
from gslm_tpu_torch.renderer import batch_render, overflow_probe
from torch_ranks import (DENSIFY_ARGS, RCFG, RCFG_ROUTE, RENDER_BG, TINY,
                         mp_state_worker, odd_params, run_ranks, tiny_scene)

J_RCFG = JRasterConfig(dup_capacity=1 << 12)
MU_SEED = 7


def _jax_tiny():
    jp, jaux = j_random_gaussians(np.random.default_rng(TINY["seed"]),
                                  n=TINY["n"], capacity=TINY["capacity"],
                                  num_images=TINY["views"])
    return jp, jaux, j_ring_camera_batch(TINY["views"], *TINY["hw"])


def _jax_noise():
    """JAX's per-shard split noise of ``make_mp_densify(PRNGKey(0))`` on a
    model axis of 2, shard-major: the whole-capacity pair the port
    takes."""
    cl = TINY["capacity"] // 2
    draws = [[], []]
    for m in range(2):
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                     m))
        for i, k in enumerate((k1, k2)):
            draws[i].append(np.asarray(jax.random.normal(k, (cl, 3))))
    return [np.concatenate(d) for d in draws]


def _mu_xyz():
    return np.random.default_rng(MU_SEED).normal(
        size=(TINY["capacity"], 3)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mp") / "ckpt")
    return run_ranks(mp_state_worker, 4, ckpt, _jax_noise(), _mu_xyz())


def _whole(outs, key, k, n_data=2):
    """A model-sharded tensor of data row 0's ranks, concatenated."""
    return torch.cat([outs[m][key][k] for m in range(len(outs) // n_data)])


def _frames(outs, name, k, H):
    """The bands of every rank stacked into frames: (B, C, H, W)."""
    rows = [torch.cat([outs[2 * d + m][name][k] for m in range(2)], dim=2)
            for d in range(2)]
    return torch.cat(rows)[:, :, :H]


def test_mesh_shapes(runs):
    """(2, 2) and (1, 4) meshes of 4 ranks: rank r is data index r // M and
    model index r % M; each axis's group sums over its ranks; a mesh that
    does not fill the world and a capacity that does not split raise. On
    one process a model axis above 1 cannot fill the world."""
    for r, o in enumerate(runs):
        assert o["shape"] == {"data": 2, "model": 2}
        assert (o["rank"], o["model_rank"]) == divmod(r, 2)
        assert o["is_main"] == (r == 0)
        assert o["row_shape"] == {"data": 1, "model": 4}
        assert o["row_rank"] == (0, r)
        d, m = divmod(r, 2)
        assert o["sums"] == [float(m + m + 2), float(4 * d + 1), 6.0, 6.0]
        assert o["misfit_raises"] and o["capacity_raises"]
    with pytest.raises(ValueError, match="fill the world"):
        make_mesh(1, 2)
    mesh = make_mesh(1, 1)
    assert mesh.rows(256) == slice(0, 256) and mesh.world_group is None


def test_shard_state_splits_rows(runs):
    params, aux, opt_state, _ = tiny_scene()
    for r, o in enumerate(runs):
        rows = slice(128 * (r % 2), 128 * (r % 2 + 1))
        for g in PARAM_GROUPS:
            want = getattr(params, g).detach()
            assert torch.equal(o["state"][g], want if g == "exposure"
                               else want[rows]), g
        assert torch.equal(o["state"]["alive"], params.alive[rows])


@pytest.mark.parametrize("name", ["gather", "route"])
def test_mp_render_views_matches_batch_render(runs, name):
    """The bands concatenate to the single process's frames, bit for bit
    on the CPU (JAX's bound: 1e-6), and to JAX's ``mp_render_views``
    within 1e-6; no overflow."""
    params, _, _, cams = tiny_scene()
    bg = torch.tensor(RENDER_BG)
    with torch.no_grad():
        ref = batch_render(params, cams, bg, config=RCFG)
    H = cams.height
    img, invd = _frames(runs, name, "image", H), _frames(runs, name,
                                                          "invdepth", H)
    assert torch.equal(img, ref.render) and torch.equal(invd, ref.invdepth)
    assert all(o[name]["overflow"] == 0 for o in runs)

    jp, jaux, jcams = _jax_tiny()
    jbg = jnp.asarray(RENDER_BG, jnp.float32)
    jcfg = J_RCFG.replace(mp_route_capacity=RCFG_ROUTE.mp_route_capacity
                          if name == "route" else 0)
    mesh = j_make_mesh(2, 2)
    p_spec, _, _ = _mp_specs(mesh, jp, j_init_adam(jp))

    def body(p_l, alive_l, cam):
        image, invdepth, _, _ = j_mp_render_views(
            p_l, cam, jbg, config=jcfg, n_model=2, alive_local=alive_l)
        return image, invdepth

    fn = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(p_spec, P("model"), P("data")),
        out_specs=(P("data", None, "model"), P("data", None, "model")),
        check_rep=False))
    jimg, jinvd = fn(jp, jaux.alive, jcams)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg)[:, :, :H],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(invd.numpy(), np.asarray(jinvd)[:, :, :H],
                               rtol=0, atol=1e-6)


def test_mp_route_overflow_flag_and_bytes(runs):
    """R = 8 raises the overflow flag on every rank (records are never
    dropped silently); ``exchange_bytes`` equals JAX's."""
    assert all(o["route8"]["overflow"] == 1 for o in runs)
    for args in ((2, 128, 2, 256), (2, 128, 2, 0), (1, 524_288, 2, 524_288),
                 (50, 65_536, 4, 0)):
        assert exchange_bytes(*args) == j_exchange_bytes(*args)
    assert exchange_bytes(2, 128, 2, 256) < exchange_bytes(2, 128, 2, 0)


def test_overflow_probe_band_counts_match_jax(runs):
    """``overflow_probe(n_model=2)``'s ``band_aabb`` and ``route_counts``
    equal JAX's; ``band_probe`` on the ranks gives the same band counts
    and each shard's row of the route counts."""
    params, _, _, cams = tiny_scene()
    got = overflow_probe(params, cams, config=RCFG_ROUTE, per_view=True,
                         n_model=2)
    jp, jaux, jcams = _jax_tiny()
    want = j_overflow_probe(jp, jcams,
                            config=J_RCFG.replace(mp_route_capacity=256),
                            alive=jaux.alive, per_view=True, n_model=2)
    for k in ("band_aabb", "route_counts", "n_aabb", "n_live"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert "route_counts" not in overflow_probe(
        params, cams, config=RCFG, per_view=True, n_model=2)
    for r, o in enumerate(runs):
        views = slice(2 * (r // 2), 2 * (r // 2) + 2)
        assert torch.equal(o["probe"]["band_aabb"], got["band_aabb"][views])
        assert torch.equal(o["probe"]["sent"],
                           got["route_counts"][views, r % 2])


def test_band_probe_on_shards_of_odd_size(runs):
    """``band_probe`` on shards of 3 rows (capacity 6 over a model axis of
    2): the band counts and each shard's row of the route counts equal
    ``overflow_probe``'s on the whole 6-row state."""
    _, _, _, cams = tiny_scene()
    got = overflow_probe(odd_params(), cams, config=RCFG_ROUTE,
                         per_view=True, n_model=2)
    assert int(got["band_aabb"].sum()) > 0
    for r, o in enumerate(runs):
        views = slice(2 * (r // 2), 2 * (r // 2) + 2)
        assert torch.equal(o["probe_odd"]["band_aabb"],
                           got["band_aabb"][views])
        assert torch.equal(o["probe_odd"]["sent"],
                           got["route_counts"][views, r % 2])


def test_sharded_checkpoint_roundtrip(runs):
    """The port's sharded format (tests/test_train_e2e.py:229): one npz per
    model index and meta.json; each rank reads its own rows back bit for
    bit, the gather is the whole state (the fixture's), and a (1, 4) mesh
    takes its quarter of it."""
    params, aux, opt_state, _ = tiny_scene()
    for r, o in enumerate(runs):
        assert o["ckpt_files"] == ["meta.json", "shard0.npz", "shard1.npz"]
        mine, it, slr = o["ckpt_mine"]
        assert (it, slr) == (777, 3.25)
        for k, v in o["state"].items():
            assert (torch.equal(mine[k], v) if torch.is_tensor(v)
                    else mine[k] == v), k
        whole = o["ckpt_whole"]
        for g in PARAM_GROUPS:
            assert torch.equal(whole[g], getattr(params, g).detach()), g
            assert torch.equal(whole[f"mu/{g}"], opt_state.mu[g]), g
        assert torch.equal(whole["alive"], params.alive)
        assert torch.equal(whole["denom"], aux.denom)
        quarter = slice(64 * r, 64 * (r + 1))
        assert torch.equal(o["ckpt_row"]["xyz"], params.xyz.detach()[quarter])
        assert torch.equal(o["ckpt_row"]["exposure"],
                           params.exposure.detach())


def test_mp_densify_on_model_sharded_state(runs):
    """``make_mp_densify`` without its rebalance, each shard fed JAX's
    per-shard draws (``fold_in(key, m)``): the counts equal JAX's
    ``make_mp_densify``'s and its single-device ``densify_and_prune``'s;
    the shards' rows equal JAX's (parameters within 1e-6, moments and
    ``alive`` equal); both data rows alike."""
    jp, jaux, _ = _jax_tiny()
    jopt = j_init_adam(jp)
    C = TINY["capacity"]
    accum = np.zeros(C, np.float32)
    accum[::5] = 1.0
    jaux = jaux.replace(xyz_gradient_accum=jnp.asarray(accum),
                        denom=jnp.ones(C, jnp.float32))
    args = tuple(jnp.float32(a) for a in DENSIFY_ARGS)
    _, _, _, ref = j_densify_and_prune(jp, jaux, jopt,
                                       jax.random.PRNGKey(0), *args)
    fn = j_make_mp_densify(j_make_mesh(2, 2), jp, jopt, rebalance=False)
    p2, a2, o2, info = fn(jp, jaux, jopt, jax.random.PRNGKey(0), *args)
    for k in ("n_cloned", "n_split", "n_pruned", "n_alive", "n_dropped"):
        assert runs[0]["densify"][k] == int(info[k]) == int(ref[k]), k
    assert runs[0]["densify"]["n_rebalanced"] == 0
    for o in runs[2:]:
        for k, v in runs[o["model_rank"]]["densify_state"].items():
            assert (torch.equal(o["densify_state"][k], v)
                    if torch.is_tensor(v) else o["densify_state"][k] == v), k
    np.testing.assert_array_equal(
        _whole(runs, "densify_state", "alive").numpy(), np.asarray(a2.alive))
    for g in PARAM_GROUPS:
        got = (runs[0]["densify_state"][g] if g == "exposure"
               else _whole(runs, "densify_state", g))
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(p2, g)),
                                   rtol=0, atol=1e-6, err_msg=g)
        for m in ("mu", "nu"):
            got = (runs[0]["densify_state"][f"{m}/{g}"] if g == "exposure"
                   else _whole(runs, "densify_state", f"{m}/{g}"))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(getattr(o2, m), g)),
                err_msg=f"{m}/{g}")


def test_mp_rebalance_moves_rows_and_preserves_render(runs):
    """Rows move from the full shard to the free ones (at most ceil(48/4) +
    1 per shard, at least 36 moved), moments travel with their rows (the
    xyz first moment's mass unchanged), the render is unchanged within
    1e-6, and every shard equals JAX's ``mp_rebalance`` on its (2, 4) mesh
    bit for bit."""
    params, _, _, cams = tiny_scene()
    alive = torch.cat([o["rebalance"]["alive"] for o in runs])
    per_shard = alive.reshape(4, 64).sum(dim=1)
    assert int(per_shard.sum()) == 48 and int(per_shard.max()) <= 13
    assert sum(o["moved"] for o in runs) >= 36, per_shard
    mu = torch.cat([o["rebalance"]["mu/xyz"] for o in runs])
    np.testing.assert_allclose(float(mu[alive].abs().sum()),
                               float(np.abs(_mu_xyz()[:48]).sum()),
                               rtol=1e-6)
    after = GaussianParams(
        **{g: (runs[0]["rebalance"][g] if g == "exposure" else
               torch.cat([o["rebalance"][g] for o in runs]))
           for g in PARAM_GROUPS}, sh_degree=3, alive=alive)
    bg = torch.zeros(3)
    with torch.no_grad():
        before = batch_render(params, cams, bg, config=RCFG).render
        now = batch_render(after, cams, bg, config=RCFG).render
    np.testing.assert_allclose(now.numpy(), before.numpy(), rtol=0,
                               atol=1e-6)

    jp, jaux, _ = _jax_tiny()
    jopt = j_init_adam(jp)
    jopt = jopt.replace(mu=jopt.mu.replace(xyz=jnp.asarray(_mu_xyz())))
    mesh = j_make_mesh(2, 4)
    p_spec, a_spec, o_spec = _mp_specs(mesh, jp, jopt)

    def body(p_l, a_l, o_l):
        p2, a2, o2, _ = j_mp_rebalance(p_l, a_l, o_l, n_model=4,
                                       donate_cap=64)
        return p2, a2, o2

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(p_spec, a_spec, o_spec),
                           out_specs=(p_spec, a_spec, o_spec),
                           check_rep=False))
    jp2, ja2, jo2 = fn(jp, jaux, jopt)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(ja2.alive))
    for g in PARAM_GROUPS:
        if g == "exposure":
            continue
        np.testing.assert_array_equal(
            torch.cat([o["rebalance"][g] for o in runs]).numpy(),
            np.asarray(getattr(jp2, g)), err_msg=g)
        np.testing.assert_array_equal(
            torch.cat([o["rebalance"][f"mu/{g}"] for o in runs]).numpy(),
            np.asarray(getattr(jo2.mu, g)), err_msg=g)
    for f in ("max_radii2d", "xyz_gradient_accum", "denom"):
        np.testing.assert_array_equal(
            torch.cat([o["rebalance"][f] for o in runs]).numpy(),
            np.asarray(getattr(ja2, f)), err_msg=f)
