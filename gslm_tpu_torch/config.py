"""Configuration groups (gslm_tpu/config.py). The optimiser group the Adam
step reads and the Levenberg–Marquardt group the LM step reads; the other
argument groups come with the trainer CLI."""

from __future__ import annotations

import dataclasses


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
