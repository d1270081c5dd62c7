"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Counterpart of ``waveome_tpu/pallas_ops``: K1 (``gram_cuda``) replaces the
fused Pallas gram, K2 (``chol_cuda``) the Pallas blocked Cholesky, K3
(``diag_factor_cuda``) the lane-batched diagonal-block factor of the
hybrid Cholesky. Each wrapper module holds the kernel's plain PyTorch
version beside it; CPU tensors go to the plain version, CUDA tensors to
the kernel.
"""
