"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W power limit)."""

F32_FLOPS = 67e12        # float32 on the CUDA cores, outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3, bytes per second
