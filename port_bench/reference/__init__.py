"""The plain PyTorch reference that decides ``correct``. It imports
neither the program (``gslm_tpu_torch``) nor JAX."""
