"""PyTorch/CUDA port of the Galaxy reproduction (hybrid TP/SP model
parallelism over uneven devices, planned by Alg. 1, with tile-level ring
overlap), for one NVIDIA Hopper GPU.

The subpackage layout mirrors ``src/repro/``: each module here has its JAX
counterpart at the same relative path.  The package imports ``torch`` and
``numpy`` only; every kernel of the serving paths is hand-written in CUDA
C++ for sm_90a (``kernels/csrc/*.cu``: among them the fused connective,
one launch per connective site, and the RG-LRU scan on a TMA ring), and
each keeps a plain PyTorch version beside it for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is absent and the CPU was not asked for,
    so a run never carries on quietly on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host"
        )
    return dev
