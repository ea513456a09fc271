"""Dataset preparation tools (gslm_tpu/tools): COLMAP conversion,
depth-scale alignment, the LPIPS weight export."""
