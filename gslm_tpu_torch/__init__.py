"""PyTorch / CUDA port of gslm_tpu for NVIDIA Hopper (H100).

Mirrors ``gslm_tpu``'s module paths. Plain tensor code is PyTorch; each
Pallas TPU kernel on a ported path is a hand-written CUDA C++ kernel under
``csrc/``, built with nvcc at first use (``_build.py``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; a wrapper around a kernel
takes the kernel's plain PyTorch version only for CPU tensors.
"""
