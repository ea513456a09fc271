"""Interactive viewer bridge (SIBR remote-viewer wire protocol)."""

from gslm_tpu_torch.viewer.network_gui import ViewerServer

__all__ = ["ViewerServer"]
