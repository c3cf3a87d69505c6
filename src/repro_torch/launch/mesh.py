"""Production meshes (counterpart of ``src/repro/launch/mesh.py``), as
``torch.distributed`` ``DeviceMesh``es over whatever process group is up.

Single pod:  16 x 16 = 256 chips, axes (data, model)
Multi-pod:   2 x 16 x 16 = 512 chips, axes (pod, data, model)

The "model" axis is the Galaxy HMP axis (TP heads/ffn/experts + SP
sequence); "data" carries batch, the FSDP weight shards and the
long-context cache shards; "pod" is the cross-pod data axis.

The reference's dry run lays these meshes over 512 forced host devices;
here :func:`ensure_fake_group` brings up ``torch.distributed``'s fake
process group of the mesh's size instead (this process is rank 0; every
collective returns at once without moving data), so a mesh of 512
"chips" costs nothing.  A real group of the right size (gloo or NCCL,
brought up by the caller) is used as it is.

The reference's ``make_mesh_compat`` has no counterpart: it papers over a
JAX version split (``AxisType`` exists only in newer JAX), and
``DeviceMesh`` has one form.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

#: the device type of a mesh whose tensors are fake: no memory anywhere
MESH_DEVICE = "cpu"


def ensure_fake_group(world_size: int) -> None:
    """Bring up the fake process group of ``world_size`` ranks (this one
    rank 0) unless a group of that size is up.  A fake group of another
    size is torn down first; a real one of another size is an error."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} "
                               f"ranks is up; a mesh of {world_size} needs its own")
        destroy_fake_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def destroy_fake_group() -> None:
    """Tear down the fake group, if one is up, and clear ``DTensor``'s
    caches of sharding decisions.  Those hold the meshes they were made on,
    each with its groups' names, and a mesh over the next group that equals
    an old one (same layout and names) would be handed the old mesh and its
    torn-down groups ("Could not resolve the process group")."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
        from torch.distributed.tensor import DTensor

        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
        clear_fast_path = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
        if clear_fast_path is not None:  # the C++ dispatch fast path's cache, where torch has one
            clear_fast_path()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device: str = MESH_DEVICE):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0..n-1,
    bringing up the fake group of n ranks if no group is up."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    ensure_fake_group(n)
    with unset_fake_temporarily():  # the rank layout is real, even inside a fake step
        return DeviceMesh(device, torch.arange(n).reshape(tuple(shape)),
                          mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: str = MESH_DEVICE):
    return make_mesh(*production_shape(multi_pod), device=device)


def make_test_mesh(model: int = 2, data: int = 1, *, device: str = MESH_DEVICE):
    """A small (data, model) mesh, for tests over a real gloo group of
    ``model * data`` ranks or the fake group."""
    return make_mesh((data, model), ("data", "model"), device=device)
