"""Multi-rank training over a (data, model) mesh (gslm_tpu/parallel) on
``torch.distributed``: one process per rank.

- ``data`` axis: camera views. Each rank renders a contiguous block of the
  views; with a model axis of 1 the parameters, moments and statistics are
  replicated, and gradients, Jᵀ·u partials, residual dots and losses are
  all-reduced over the ranks.
- ``model`` axis: the Gaussian capacity axis. Each rank holds its block of
  the rows, renders its tile-row band of its views from the splats the
  model group exchanges (an all_gather, or a routed all_to_all), and
  densifies its shard, rows moving between shards after each event.

See mesh.py for the mesh, the process groups and the collectives, comm.py
for the collectives that carry derivatives, model_raster.py for the band
raster and steps.py for the step factories.
"""

from gslm_tpu_torch.parallel.mesh import (Mesh, gather_state, make_mesh,
                                          maybe_initialize_distributed,
                                          shard_cameras, shard_state)
from gslm_tpu_torch.parallel.steps import (dp_apply_update, make_dp_lm_step,
                                           make_dp_train_step,
                                           make_mp_densify, make_mp_lm_step,
                                           make_mp_train_step,
                                           make_sharded_lm_step,
                                           make_sharded_train_step,
                                           mp_apply_update,
                                           mp_loss_and_grads)

__all__ = [
    "Mesh", "make_mesh", "maybe_initialize_distributed", "shard_cameras",
    "shard_state", "gather_state", "make_sharded_train_step",
    "make_sharded_lm_step", "make_dp_train_step", "make_dp_lm_step",
    "dp_apply_update", "make_mp_train_step", "make_mp_lm_step",
    "make_mp_densify", "mp_loss_and_grads", "mp_apply_update",
]
