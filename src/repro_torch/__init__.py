"""The DMAC reproduction in PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference (``repro``): the same modules at
the same relative paths, with the TPU kernels rewritten as hand-written
CUDA kernels (:mod:`repro_torch.kernels`). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
