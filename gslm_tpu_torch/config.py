"""Configuration groups and the command-line plumbing (gslm_tpu/config.py).

The five groups carry the JAX package's fields and defaults, so one command
line runs both packages: ``ModelParams`` (scene and output paths),
``PipelineParams``, ``OptimizationParams`` (the Adam phase),
``LMParams`` (the Levenberg–Marquardt phase) and ``TpuParams``
(capacities and execution knobs). Fields the JAX package accepts and
ignores (``data_device``, ``convert_SHs_python``, ``compute_cov3D_python``,
``debug``) are accepted and ignored here too. Fields that only configure
TPU execution raise at any value but their default, as ``RasterConfig``'s
do.

Configs persist to ``<model>/cfg_args`` as JSON; ``get_combined_args``
reads that or the reference's ``Namespace`` repr."""

from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser, BooleanOptionalAction, Namespace



@dataclasses.dataclass(frozen=True)
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    data_device: str = "tpu"           # accepted and ignored, as in JAX
    eval: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    convert_SHs_python: bool = False   # accepted and ignored, as in JAX:
    compute_cov3D_python: bool = False  # SH and covariance are always
    debug: bool = False                 # evaluated in the preprocess
    antialiasing: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 0.001
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    random_background: bool = False
    optimizer_type: str = "default"    # "default" | "sparse_adam"


@dataclasses.dataclass(frozen=True)
class LMParams:
    """Levenberg–Marquardt phase (reference train_jvp.py defaults).

    ``ls_subset_views`` > 0 ranks the line-search alphas on a stride-sampled
    subset of about that many val views, ``ls_val_scale`` > 1 on the val
    views at 1/s resolution (s x s average-pooled targets); either way the
    winner is then scored on the full set at full resolution, so
    ``best_val_loss`` stays exact. 0 and 1 are reference-faithful.
    ``val_pack`` is a record packing of the TPU kernels (unused by the
    port): any value but 0 raises."""

    jvp_start: int = 15_001            # train_jvp.py:428
    num_images: int = 5                # LM view-batch size, train_jvp.py:429
    cg_max_iter: int = 2               # train_jvp.py:255
    cg_restart_iter: int = 1           # train_jvp.py:256
    micro_batch: int = 5               # solver micro-batch (reference 20)
    disable_ssim: bool = True          # train_jvp.py:212
    damp_xyz: float = 5e2              # train_jvp.py:229-235
    damp_features_dc: float = 5e-2
    damp_features_rest: float = 5e-2
    damp_scaling: float = 5e-2
    damp_rotation: float = 5e-2
    damp_opacity: float = 5e-2
    damp_exposure: float = 1e1
    mask_xyz: bool = True              # train_jvp.py:221-228
    line_search_alpha0: float = 2.0    # train_jvp.py:264-280
    line_search_steps: int = 6
    num_val_views: int = 50            # train_jvp.py:214-216
    val_view_stride: int = 19
    check_divergence: bool = True
    ls_val_scale: int = 1
    val_pack: int = 0
    ls_subset_views: int = 0

    def __post_init__(self):
        if self.val_pack != 0:
            raise NotImplementedError(
                f"val_pack={self.val_pack}: a record packing of the TPU "
                "kernels, unused by the port; leave it at 0")

    def damp_dict(self) -> dict[str, float]:
        return {"xyz": self.damp_xyz, "features_dc": self.damp_features_dc,
                "features_rest": self.damp_features_rest,
                "scaling": self.damp_scaling, "rotation": self.damp_rotation,
                "opacity": self.damp_opacity, "exposure": self.damp_exposure}


@dataclasses.dataclass(frozen=True)
class TpuParams:
    """Capacities and execution knobs. ``capacity`` (0: from the point
    count), ``dup_capacity``, ``live_capacity``, ``raster_cull``,
    ``raster_impl``, ``mesh_data`` and ``mesh_model`` (the data axis:
    views split over that many ``torch.distributed`` ranks; the model
    axis: Gaussians sharded over that many) and ``mp_route_capacity`` (the
    model axis's routed-record capacity, 0 for its all_gather) are read.
    ``max_per_tile``, ``tile_chunk``, ``raster_pack`` and ``cache_dir``
    configure the TPU kernels and XLA only: any value but their default
    raises."""

    capacity: int = 0
    dup_capacity: int = 1 << 21
    max_per_tile: int = 1024
    tile_chunk: int = 64
    raster_impl: str = "auto"
    raster_pack: int = 0
    raster_cull: bool = True
    live_capacity: int = 0
    mesh_data: int = 1
    mesh_model: int = 1
    mp_route_capacity: int = 0
    cache_dir: str = ""

    def __post_init__(self):
        from gslm_tpu_torch.renderer import resolve_impl
        for name in ("max_per_tile", "tile_chunk", "raster_pack",
                     "cache_dir"):
            default = _FIELD_DEFAULTS[name]
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} configures the TPU "
                    f"execution only, which the port does not have; leave "
                    f"it at {default!r}")
        resolve_impl(self.raster_impl)

_FIELD_DEFAULTS = {f.name: f.default for f in dataclasses.fields(TpuParams)}

_GROUPS = {"model": ModelParams, "pipeline": PipelineParams,
           "opt": OptimizationParams, "lm": LMParams, "tpu": TpuParams}

_SHORTHAND = {"source_path": "-s", "model_path": "-m", "images": "-i",
              "depths": "-d", "resolution": "-r", "white_background": "-w"}


def add_all_args(parser: ArgumentParser, groups=("model", "pipeline", "opt",
                                                 "lm", "tpu")):
    """One argument group per config group: ``--<field>`` (and the
    reference's shorthand), booleans as ``--x`` / ``--no-x``."""
    for gname in groups:
        cls = _GROUPS[gname]
        grp = parser.add_argument_group(gname)
        for f in dataclasses.fields(cls):
            flags = [f"--{f.name}"]
            if f.name in _SHORTHAND:
                flags.append(_SHORTHAND[f.name])
            if f.type == "bool" or f.type is bool:
                grp.add_argument(*flags, action=BooleanOptionalAction,
                                 default=f.default)
            else:
                grp.add_argument(*flags, type=type(f.default),
                                 default=f.default)


def extract(args: Namespace, cls):
    """The ``cls`` config group of a parsed ``Namespace``."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


def save_cfg_args(model_path: str, args: Namespace):
    """Persist the merged config as ``<model_path>/cfg_args`` (JSON of the
    scalar arguments)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, type(None)))}, f,
                  indent=2)


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """The command line (``argv``, default ``sys.argv[1:]``) over the saved
    ``cfg_args`` of its ``--model_path``: a saved value stays unless the
    command line gives a value other than the parser's default. Reads the
    JSON this module writes, else the reference's ``Namespace`` repr."""
    import sys
    args_cmdline = parser.parse_args(sys.argv[1:] if argv is None else argv)
    merged = {}
    cfgpath = os.path.join(args_cmdline.model_path or "", "cfg_args")
    if args_cmdline.model_path and os.path.exists(cfgpath):
        with open(cfgpath) as f:
            text = f.read()
        try:
            merged = json.loads(text)
        except json.JSONDecodeError:
            ns = eval(text, {"Namespace": Namespace})  # reference format
            merged = vars(ns)
    defaults = {a.dest: parser.get_default(a.dest)
                for a in parser._actions if a.dest != "help"}
    for k, v in vars(args_cmdline).items():
        if v is not None and (k not in merged or v != defaults.get(k)):
            merged[k] = v
    return Namespace(**merged)
