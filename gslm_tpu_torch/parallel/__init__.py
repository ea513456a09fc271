"""Multi-rank training over a (data, model) mesh (gslm_tpu/parallel) on
``torch.distributed``: one process per rank.

- ``data`` axis: camera views. Each rank renders a contiguous block of the
  views through the single-process code and kernels; the parameters,
  moments and statistics are replicated; gradients, Jᵀ·u partials,
  residual dots and losses are all-reduced over the ranks.
- ``model`` axis (Gaussians sharded, tile-row bands): not ported yet.

See mesh.py for the mesh, the process group and the collectives, and
steps.py for the data-parallel step factories.
"""

from gslm_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                          maybe_initialize_distributed,
                                          shard_cameras, shard_state)
from gslm_tpu_torch.parallel.steps import (dp_apply_update, make_dp_lm_step,
                                           make_dp_train_step,
                                           make_sharded_lm_step,
                                           make_sharded_train_step)

__all__ = [
    "Mesh", "make_mesh", "maybe_initialize_distributed", "shard_cameras",
    "shard_state", "make_sharded_train_step", "make_sharded_lm_step",
    "make_dp_train_step", "make_dp_lm_step", "dp_apply_update",
]
