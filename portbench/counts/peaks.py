"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at its full power limit of 700 W."""

#: Dense bf16 tensor-core operations a second.
BF16_FLOPS = 989.4e12
#: fp32 operations a second on the CUDA cores (no tensor cores).
FP32_FLOPS = 67e12
#: HBM3 bytes a second.
HBM_BYTES = 3.35e12


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time for the work: the bytes at the memory rate or the
    operations at ``ops_per_s``, whichever is larger."""
    return max(n_bytes / HBM_BYTES, n_ops / ops_per_s)
