"""Shared inputs of the port's training and multimodal parity tests: the
reference's parameter tree drawn with numpy, and one numpy batch, handed
to both packages; the dispatch mode that holds a captured step's code to
reading nothing on the host; and a stand-in for the card's graph runtime
whose replays re-run the captured step."""
import jax
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.params import PSpec as JPSpec
from repro.models.params import model_spec as j_model_spec


def numpy_params(jcfg, seed=0, boost=4.0):
    """The reference's parameter tree drawn with numpy: matrices at
    ``boost`` x the init scale, zero- and one-init leaves (norm scales,
    biases, the cross-attention gate) at seeded random values around
    their init, so no path is constant; ``lru_a`` by its own rule."""
    rng = np.random.default_rng(seed)

    def make(path, ps):
        grouped = getattr(path[0], "key", None) == "groups"
        shape = ((jcfg.num_groups,) if grouped else ()) + ps.shape
        if ps.init == "lru_a":
            u = rng.uniform(0.9, 0.999, shape)
            return np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
        if ps.init in ("zeros", "ones"):
            base = 1.0 if ps.init == "ones" else 0.0
            spread = 0.5 if path[-1].key == "xgate" else 0.1
            return (base + spread * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = min(ps.scale, 1.0 / np.sqrt(fan_in))
        b = 1.0 if path[-1].key == "tok" else boost
        return (rng.standard_normal(shape) * scale * b).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        make, j_model_spec(jcfg), is_leaf=lambda x: isinstance(x, JPSpec))


def flat_tree(tree):
    """{'/'-joined path: numpy leaf} of a JAX pytree (the checkpoint key
    names)."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


aten = torch.ops.aten
#: a host read, or an output whose size depends on the data (a sync on the card)
HOST_READS = {aten._local_scalar_dense, aten.item, aten.nonzero, aten.masked_select,
              aten.is_nonzero, aten.equal, aten._unique2, aten.unique_consecutive}


class NoHostReads(TorchDispatchMode):
    """Raises on an op that reads a tensor's value on the host, or sizes its
    output by the data (boolean-mask indexing among them).  With
    ``host_data=True`` it also raises where a tensor is built from host
    data: ``torch.tensor``, ``torch.as_tensor`` or ``torch.from_numpy`` of
    a numpy array, a list or a Python scalar, and indexing by an array or
    a list (each lifts a fresh host tensor, ``aten.lift_fresh``), which on
    the card is a copy from pageable host memory that a capture refuses."""

    def __init__(self, host_data: bool = False):
        super().__init__()
        self.host_data = host_data

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            raise AssertionError(f"host read in the step: {func}")
        if self.host_data and func.overloadpacket in (aten.lift_fresh, aten.lift_fresh_copy):
            raise AssertionError(f"a tensor built from host data in the step: {func}")
        if func.overloadpacket in (aten.index, aten.index_put, aten.index_put_):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in args[1] if i is not None):
                raise AssertionError(f"boolean-mask indexing in the step: {func}")
        return func(*args, **(kwargs or {}))


class ReplayGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``: a replay runs the
    captured closure again, on the graph's buffers, into its output
    buffer."""

    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        new = self.fn()
        self.out.resize_(new.shape).copy_(new)
        self.replays += 1


class StandInRuntime:
    """``serving/graphs.py:CudaRuntime`` on the CPU.  A capture runs
    nothing, as on the card (a step updates its cache in place), and its
    graph re-runs the captured closure at each replay."""

    class _Event:
        def record(self):
            pass

        def synchronize(self):
            pass

    def __init__(self):
        self.graphs = []

    def check(self, device):
        return torch.device(device)

    def host(self, shape):
        return torch.empty(shape, dtype=torch.int64)

    def event(self):
        return self._Event()

    def stream(self, device):
        return None

    def pool(self):
        return object()

    def warm(self, stream, fn):
        return fn()

    def capture(self, stream, fn, pool):
        out = torch.empty(0)
        self.graphs.append(ReplayGraph(fn, out))
        return self.graphs[-1], out, 4096

    def allocated(self, device):
        return 0


class CountingGraph:
    """Stands in for a captured graph whose replay launches nothing here:
    it only counts."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class CountingRuntime(StandInRuntime):
    """A :class:`StandInRuntime` whose capture runs the step once, for its
    output buffer, and whose graphs only count their replays."""

    def capture(self, stream, fn, pool):
        self.graphs.append(CountingGraph())
        return self.graphs[-1], fn(), 4096
