"""Hand-written Hopper kernels of the serving path (valid-length GEMM,
ragged flash attention, fused connective), each beside its plain PyTorch
version, and the backend dispatch of ``ops``."""
