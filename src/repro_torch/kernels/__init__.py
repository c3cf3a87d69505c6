"""Hand-written Hopper kernels (valid-length GEMM, ragged and dense flash
attention, fused connective, RG-LRU scan), each beside its plain PyTorch
version, and the backend dispatch of ``ops``."""
