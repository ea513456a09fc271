"""gslm_tpu_torch's configuration groups and command lines (config.py and
the entry points' parsers) against gslm_tpu's. Everything here is exact:
option strings, destinations, defaults, extracted dataclasses, the bytes
of ``cfg_args`` and the merged namespaces."""

import dataclasses
import json
import sys
from argparse import ArgumentParser, Namespace

import pytest

import gslm_tpu.config as j_cfg
import gslm_tpu.train as j_train
from gslm_tpu_torch import config as cfg_mod
from gslm_tpu_torch import train as t_train
from gslm_tpu_torch.eval import metrics as t_metrics
from gslm_tpu_torch.eval import render_sets as t_render_sets
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig

GROUPS = ("model", "pipeline", "opt", "lm", "tpu")


def _options(parser: ArgumentParser, skip=("help",)) -> dict:
    """{dest: (option strings, default, nargs, type)} of a parser."""
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                     getattr(a.type, "__name__", a.type))
            for a in parser._actions if a.dest not in skip}


@pytest.mark.parametrize("group", GROUPS)
def test_add_all_args_matches_jax_group_by_group(group):
    got, want = ArgumentParser(), ArgumentParser()
    cfg_mod.add_all_args(got, groups=(group,))
    j_cfg.add_all_args(want, groups=(group,))
    assert _options(got) == _options(want)
    assert ([a.title for a in got._action_groups]
            == [a.title for a in want._action_groups])


def test_entry_point_parsers_match_jax():
    """The trainer's flags are JAX's. render_sets and metrics have JAX's
    flags (JAX builds those parsers inside ``main``, as below) and
    ``--platform`` (JAX picks its platform from the environment)."""
    assert _options(t_train.build_parser()) == _options(
        j_train.build_parser())
    render = ArgumentParser()
    j_cfg.add_all_args(render, groups=("model", "pipeline", "tpu"))
    render.add_argument("--iteration", default=-1, type=int)
    for flag in ("--skip_train", "--skip_test", "--quiet"):
        render.add_argument(flag, action="store_true")
    metrics = ArgumentParser()
    metrics.add_argument("--model_paths", "-m", required=True, nargs="+")
    metrics.add_argument("--no_lpips", action="store_true")
    for mine, want in ((t_render_sets.build_parser(), render),
                       (t_metrics.build_parser(), metrics)):
        got = _options(mine)
        assert got.pop("platform") == (("--platform",), "", None, "str")
        assert got == _options(want)


def test_extract_gives_equal_dataclasses():
    argv = ["-s", "src", "-m", "out", "-r", "2", "--eval", "--no-mask_xyz",
            "--iterations", "77", "--dup_capacity", "4096",
            "--live_capacity", "2048", "--num_images", "3", "--antialiasing",
            "--lambda_dssim", "0.3", "--capacity", "512"]
    got = t_train.build_parser().parse_args(argv)
    want = j_train.build_parser().parse_args(argv)
    for name in ("ModelParams", "PipelineParams", "OptimizationParams",
                 "LMParams", "TpuParams"):
        a = cfg_mod.extract(got, getattr(cfg_mod, name))
        b = j_cfg.extract(want, getattr(j_cfg, name))
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name


def test_save_cfg_args_byte_identical(tmp_path):
    argv = ["-s", "src", "-m", str(tmp_path), "--eval", "--iterations", "9",
            "--test_iterations", "3", "9"]
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    cfg_mod.save_cfg_args(str(t_dir), t_train.build_parser().parse_args(argv))
    j_cfg.save_cfg_args(str(j_dir), j_train.build_parser().parse_args(argv))
    assert (t_dir / "cfg_args").read_bytes() == (j_dir / "cfg_args"
                                                 ).read_bytes()


@pytest.mark.parametrize("form", ["json", "namespace"])
def test_get_combined_args_merges_equally(tmp_path, monkeypatch, form):
    """Saved values stay unless the command line gives a non-default one;
    JSON (this package's) and the reference's Namespace repr alike."""
    saved = {"source_path": "/data/scene", "model_path": str(tmp_path),
             "resolution": 2, "eval": True, "white_background": True,
             "sh_degree": 1, "iterations": 123}
    text = (json.dumps(saved) if form == "json"
            else repr(Namespace(**saved)))
    (tmp_path / "cfg_args").write_text(text)
    argv = ["-m", str(tmp_path), "--iteration", "7", "--sh_degree", "2",
            "-r", "-1"]

    def parser(mod):
        p = ArgumentParser()
        mod.add_all_args(p, groups=("model", "pipeline", "tpu"))
        p.add_argument("--iteration", default=-1, type=int)
        return p

    got = cfg_mod.get_combined_args(parser(cfg_mod), argv)
    monkeypatch.setattr(sys, "argv", ["render"] + argv)
    want = j_cfg.get_combined_args(parser(j_cfg))
    assert vars(got) == vars(want)
    assert got.resolution == 2 and got.sh_degree == 2 and got.eval is True


@pytest.mark.parametrize("field,value", [
    ("max_per_tile", 128), ("tile_chunk", 8), ("raster_pack", 8),
    ("mp_route_capacity", 1024), ("cache_dir", "/tmp/xla"),
    ("mesh_model", 2), ("raster_impl", "pallas"),
    ("raster_impl", "tiled")])
def test_tpu_only_fields_raise(field, value):
    """The TPU-only fields raise; the model axis's two (``mesh_model``,
    ``mp_route_capacity``), ported, are read as JAX reads them."""
    if field in ("mesh_model", "mp_route_capacity"):
        assert getattr(cfg_mod.TpuParams(**{field: value}), field) == value
    else:
        with pytest.raises(NotImplementedError, match=field.split("_")[0]
                           if field != "raster_impl" else "impl"):
            cfg_mod.TpuParams(**{field: value})
    # accepted by JAX, and the defaults by both
    j_cfg.TpuParams(**{field: value})
    cfg_mod.TpuParams()


def test_mesh_data_is_read():
    """Both mesh axes are ported: ``mesh_data``, ``mesh_model`` and the
    model axis's exchange capacity are accepted, and
    ``make_raster_config`` carries the capacity, as JAX's does."""
    from gslm_tpu.train import make_raster_config as j_make_raster_config
    from gslm_tpu_torch.train import make_raster_config
    assert cfg_mod.TpuParams(mesh_data=2).mesh_data == 2
    for kw in ({"mesh_data": 2, "mesh_model": 2}, {"mesh_model": 4},
               {"mp_route_capacity": 256}):
        tpu = cfg_mod.TpuParams(**kw)
        assert all(getattr(tpu, k) == v for k, v in kw.items())
    assert RasterConfig(mp_route_capacity=256).grow().mp_route_capacity == 512
    tpu = {"mp_route_capacity": 4096, "mesh_model": 2}
    got = make_raster_config(cfg_mod.TpuParams(**tpu),
                             cfg_mod.PipelineParams(), 64, 64, 1000)
    want = j_make_raster_config(j_cfg.TpuParams(**tpu), j_cfg.PipelineParams(),
                                64, 64, 1000)
    assert got.mp_route_capacity == want.mp_route_capacity == 4096


def test_ignored_fields_are_accepted():
    """The fields JAX accepts and ignores are accepted here too."""
    cfg_mod.ModelParams(data_device="cuda")
    cfg_mod.PipelineParams(convert_SHs_python=True, compute_cov3D_python=True,
                           debug=True)
    assert dataclasses.asdict(cfg_mod.ModelParams()) == dataclasses.asdict(
        j_cfg.ModelParams())
    assert dataclasses.asdict(cfg_mod.PipelineParams()) == dataclasses.asdict(
        j_cfg.PipelineParams())
