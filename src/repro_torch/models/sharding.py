"""Logical-axis sharding rules: the bridge between the model code and the
Galaxy HMP layout over many chips (counterpart of
``src/repro/models/sharding.py``).

Model code annotates activations with *logical* axis names through
``constrain(x, ("batch", "seq", "embed"))``.  A :class:`Rules` table maps
logical names to mesh axes, and the HMP layout is that table alone:

* ``heads`` / ``ffn`` / ``experts``  -> "model"   (TP blocks: MHA and MLP/MoE)
* ``seq``                            -> "model"   (SP connective blocks)
* ``batch``                          -> ("pod", "data")

Under a ``torch.distributed`` ``DeviceMesh`` the tensors are ``DTensor``s
and ``constrain`` redistributes one to the placements its names give, so
the paper's synchronization points appear where GSPMD puts them in the
reference: leaving a seq-sharded connective block for a head-sharded TP
block is an AllGather, and the partial sums of a row-parallel GEMM
constrained back to seq-sharded are a ReduceScatter (§III-B-4).

:meth:`Rules.spec` returns a plain tuple with the entries of the
reference's ``PartitionSpec`` (tensor dim -> mesh axes);
:meth:`Rules.placements` turns it into one ``Placement`` per mesh dim
(mesh dim -> tensor dim), the form ``DTensor`` takes.

With no rules, or rules without a mesh, ``constrain`` returns its input
after one thread-local read: every serve and train path runs so.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything whose
    ``shape`` is that dict, as the reference's meshes and test stand-ins)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclass
class Rules:
    """Mapping from logical axis names to mesh axes (or None = replicated)."""

    mapping: Dict[str, MeshAxes] = field(default_factory=dict)
    mesh: Optional[object] = None

    def axis_size(self, name: str) -> int:
        """Product of the mesh-axis sizes a logical axis maps to (1 if
        unmapped or without a mesh)."""
        ax = self.mapping.get(name)
        if ax is None or self.mesh is None:
            return 1
        sizes = mesh_axis_sizes(self.mesh)
        size = 1
        for a in (ax,) if isinstance(ax, str) else ax:
            size *= sizes[a]
        return size

    def spec(self, names: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """Mesh axes of each tensor dim for logical axis names.  With a
        ``shape``, mesh axes that do not divide a dim evenly are dropped
        (8 KV heads on a 16-way model axis -> replicated); of a tuple
        mapping the prefix that still divides is kept.  A mesh axis is used
        by the first dim that claims it only."""
        sizes = mesh_axis_sizes(self.mesh) if self.mesh is not None else None
        used: set = set()

        def resolve(name, dim):
            if name is None:
                return None
            ax = self.mapping.get(name)
            if ax is None:
                return None
            ax = tuple(a for a in ((ax,) if isinstance(ax, str) else ax) if a not in used)
            if not ax:
                return None
            if dim is not None and sizes is not None:
                kept, prod = [], 1
                for a in ax:
                    if dim % (prod * sizes[a]):
                        break
                    kept.append(a)
                    prod *= sizes[a]
                ax = tuple(kept)
                if not ax:
                    return None
            used.update(ax)
            return ax if len(ax) > 1 else ax[0]

        dims = list(shape) if shape is not None else [None] * len(names)
        return tuple(resolve(n, d) for n, d in zip(names, dims))

    def placements(self, spec: Spec):
        """``DTensor`` placements of a spec on this rules' mesh: ``Shard(d)``
        on every mesh dim that tensor dim ``d`` maps to, ``Replicate()``
        elsewhere.  A tuple entry such as ("pod", "data") shards dim ``d``
        on both mesh dims, major to minor, which is the mesh's order.  A
        mesh dim of size 1 stays ``Replicate()``: its one shard is the
        whole tensor, and ``DTensor``'s view rules cannot drop or merge a
        dim of size 1 that is sharded."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {ax} is not in the mesh's order {names}")
            for i in idx:
                if self.mesh.size(i) > 1:
                    out[i] = Shard(d)
        return tuple(out)


_STATE = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[Rules]):
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def _place(x, rules: Rules, spec: Spec):
    """``x`` as a ``DTensor`` on the rules' mesh placed by ``spec``: a plain
    tensor (a constant the model made, the same on every rank) enters
    replicated, as GSPMD treats an unannotated constant, and is then
    sliced locally; a ``DTensor`` is redistributed."""
    from torch.distributed.tensor import DTensor, Replicate

    register_strategies()
    want = rules.placements(spec)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, rules.mesh, [Replicate()] * rules.mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def project(x, w, names: Sequence[Optional[str]], shape: Sequence[int]):
    """``x @ w`` for a projection whose output (..., n * hd) is viewed as
    ``shape`` (..., n, hd) next, laid out by ``names`` (their divisibility
    that of ``shape``).  Where the heads take the model axis this is the
    plain product, its flat dim split as the heads.  Where they cannot (8 KV heads on 16 chips;
    the SP layout's queries) the weight is gathered whole and each chip
    projects its own rows of ``x``, sliced first to the layout ``names``
    give: the product never shards a feature dim the heads cannot
    follow."""
    rules = getattr(_STATE, "rules", None)
    if rules is None or rules.mesh is None:
        return x @ w
    spec = rules.spec(names, shape=shape)
    k = x.dim() - 1
    if any(a is not None for a in spec[k + 1:]):
        raise ValueError(f"{names} splits a trailing factor of the flat dim of {tuple(shape)}")
    if spec[k] is not None:
        # a split leading factor (the heads) splits the flat dim evenly
        return _place(x @ w, rules, spec[:k + 1])
    x = _place(x, rules, spec[:k] + (None,))
    w = _place(w, rules, (None,) * w.dim())
    return rowwise(lambda a, b: a @ b, x, w)


def matmul(x, w):
    """``x @ w``.  On a ``DTensor`` whose row dims are sharded (batch or
    sequence, as the SP layout leaves attention's output) and whose
    contracted dim is whole, the weight is gathered whole and each chip
    multiplies its own rows: merging a sharded row dim into one matmul dim
    gives a strided placement that the sharding propagation does not
    handle (torch 2.11 refuses even one such dim)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x @ w
    dims = {p.dim for p in x.placements if isinstance(p, Shard)}
    if x.dim() - 1 in dims or not dims:
        return x @ w
    rules = getattr(_STATE, "rules", None)
    return rowwise(lambda a, b: a @ b, x, _place(w, rules, (None,) * w.dim()))


_REGISTERED = []


def register_strategies() -> None:
    """Sharding strategies ``DTensor`` lacks for ops the models run (once
    per process): ``log_sigmoid_forward`` and its backward are pointwise
    (the forward's second output is the CPU kernel's buffer, shaped as
    the input)."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_forward.default)
    def _log_sigmoid_forward(x):
        return [([Replicate(), Replicate()], [Replicate()])] + [
            ([Shard(d), Shard(d)], [Shard(d)]) for d in range(x.ndim)]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad, x, buffer):
        return [([Replicate()], [Replicate(), Replicate(), Replicate()])] + [
            ([Shard(d)], [Shard(d), Shard(d), Shard(d)]) for d in range(x.ndim)]

    _REGISTERED.append(True)


def local_shape_offset(shape, mesh, placements) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of global ``shape`` placed evenly by
    ``placements`` on ``mesh``: its shape and its offset in each dim (mesh
    dims that shard one tensor dim split it major to minor)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways")
            local[p.dim] //= n
            offset[p.dim] += coord[i] * local[p.dim]
    return tuple(local), tuple(offset)


def fake_mode():
    """The active ``FakeTensorMode``, or a new one: enter it around every
    abstract tensor of one step, which must share a mode."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    return detect_fake_mode() or FakeTensorMode()


def abstract_tensor(shape, dtype, rules: Optional[Rules] = None,
                    names: Optional[Sequence[Optional[str]]] = None, device: str = "cpu"):
    """A fake tensor of ``shape`` and ``dtype`` (nothing allocated), or
    under rules with a mesh a ``DTensor`` over a fake local shard placed by
    ``names``, in the active ``FakeTensorMode`` (see :func:`fake_mode`)."""
    shape = tuple(shape)
    with fake_mode():
        if rules is None or rules.mesh is None:
            return torch.empty(shape, dtype=dtype, device=device)
        from torch.distributed.tensor import DTensor

        placements = rules.placements(rules.spec(names, shape=shape))
        local_shape, _ = local_shape_offset(shape, rules.mesh, placements)
        local = torch.empty(local_shape, dtype=dtype, device=device)
        return DTensor.from_local(local, rules.mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=contiguous_stride(shape))


def constrain(x, names: Sequence[Optional[str]]):
    """Apply a (shape-aware) sharding constraint if rules with a mesh are
    active; otherwise return ``x``."""
    rules = getattr(_STATE, "rules", None)
    if rules is None or rules.mesh is None:
        return x
    return _place(x, rules, rules.spec(names, shape=x.shape))


def logical_axis_size(name: str) -> int:
    """Mesh extent a logical axis would shard over under the active rules."""
    rules = current_rules()
    if rules is None:
        return 1
    return rules.axis_size(name)


def logical_to_spec(names: Sequence[Optional[str]], rules: Rules) -> Spec:
    return rules.spec(names)


def same_grad_layout(x):
    """``x``, whose gradient is laid out as ``x`` itself before it flows
    on (a ``DTensor`` op's gradient may come back split on a dim that the
    op before cannot take, as a merge of heads that are not split)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _SameGradLayout.apply(x)


class _SameGradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


def mesh_active() -> bool:
    """Whether rules with a mesh are active (the model then runs on
    ``DTensor``s)."""
    rules = getattr(_STATE, "rules", None)
    return rules is not None and rules.mesh is not None


def write_rows(dst, src, dim: int, start: int) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim``, in place.  On
    a ``DTensor`` each rank writes the rows of the update that fall in its
    own shard of ``dst`` into its local tensor, as a sharded
    dynamic-update-slice runs on every chip: ``src`` is first laid out as
    ``dst`` on every other dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    src = _local_as(src, dst.device_mesh,
                    tuple(Replicate() if p == Shard(dim) else p for p in dst.placements))
    local = dst.to_local()
    shape, offset = local_shape_offset(dst.shape, dst.device_mesh, dst.placements)
    lo, hi = max(start, offset[dim]), min(start + n, offset[dim] + shape[dim])
    if lo < hi:
        local.narrow(dim, lo - offset[dim], hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


def _paired_placements(x, dim: int):
    """Placements of ``x[..., i, j, ...]`` (1-D ``i``, ``j`` on ``dim`` and
    ``dim + 1``) for ``x``'s; the two indexed dims must be whole."""
    from torch.distributed.tensor import Shard

    out = []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim in (dim, dim + 1):
            raise ValueError(f"dims {dim} and {dim + 1} of {tuple(x.shape)} are indexed, and "
                             f"{x.placements} splits one")
        out.append(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > dim else p)
    return tuple(out)


def _local_as(src, mesh, placements):
    """This rank's shard of ``src`` laid out by ``placements`` (a plain
    ``src`` is the same on every rank and is sliced locally)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(src.placements) != tuple(placements):
        src = src.redistribute(mesh, placements)
    return src.to_local()


def take_pages(x, dim: int, table):
    """Dense views of pages: ``x``'s dims ``dim`` (pages) and ``dim + 1``
    (positions in a page) read through ``table`` (B, W) page ids as (B, W *
    page), a copy of those pages only.  On a ``DTensor`` each rank gathers
    from its own shard, which holds every page of its part of the other
    dims (under the prefill rules: its KV heads), and the view keeps that
    layout: no collective.  (torch 2.11 has no ``DTensor`` rule for indexing
    by a tensor.)"""
    from torch.distributed.tensor import DTensor

    def gather(t):
        g = t[(slice(None),) * dim + (table,)]
        return g.reshape(*g.shape[:dim + 1], -1, *g.shape[dim + 3:])

    if not isinstance(x, DTensor):
        return gather(x)
    _paired_placements(x, dim)
    shape = (*x.shape[:dim], table.shape[0], table.shape[1] * x.shape[dim + 1],
             *x.shape[dim + 2:])
    return from_local(gather(x.to_local()), x.device_mesh, x.placements, shape)


def take_pairs(x, dim: int, i, j):
    """``x[..., i, j, ...]`` with 1-D ``i`` and ``j`` indexing dims ``dim`` and
    ``dim + 1`` together: one row a pair.  On a ``DTensor`` whose two indexed
    dims are whole each rank picks from its own shard: no collective."""
    from torch.distributed.tensor import DTensor

    index = (slice(None),) * dim + (i, j)
    if not isinstance(x, DTensor):
        return x[index]
    shape = (*x.shape[:dim], i.shape[0], *x.shape[dim + 2:])
    return from_local(x.to_local()[index], x.device_mesh, _paired_placements(x, dim), shape)


def put_pairs(dst, dim: int, i, j, src) -> None:
    """``dst[..., i, j, ...] = src`` in place, the pairs of :func:`take_pairs`
    (a page scatter, a per-slot cache write).  On a ``DTensor`` each rank
    writes its own shard from ``src`` laid out as ``take_pairs(dst, ...)``
    would be, a local slice where ``src`` is whole: no collective."""
    from torch.distributed.tensor import DTensor

    index = (slice(None),) * dim + (i, j)
    if not isinstance(dst, DTensor):
        dst[index] = src
        return
    local = _local_as(src, dst.device_mesh, _paired_placements(dst, dim))
    dst.to_local()[index] = local


def rowwise(fn, x, w):
    """``fn(x, w)`` for a ``w`` that is whole on every chip (replicated)
    and an ``fn`` that works on each row of ``x``'s leading dims alone (a
    projection): on a ``DTensor`` each chip applies it to its own rows,
    and the output keeps ``x``'s row shards.  ``w``'s gradient is then a
    partial sum over the mesh dims that shard ``x``.  (Merging two sharded
    leading dims into one matmul dim, as a 3-D ``x @ w`` does, gives a
    strided placement that the sharding propagation does not handle.)"""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim >= x.dim() - 1
                                      for p in x.placements):
        raise ValueError(f"rowwise contracts x's last dim, which {x.placements} splits")
    return by_rows(lambda xs, ws: fn(xs[0], ws[0]), [x], [w])


def by_rows(fn, rows, whole):
    """``fn(rows, whole)`` where ``fn`` treats each row of the leading
    (batch) dims of the tensors in ``rows`` on its own and ``whole`` holds
    replicated tensors (weights).  On ``DTensor``s each chip runs ``fn`` on
    its local shards; the tensors ``fn`` returns keep the first row
    tensor's row shards, and the gradients of ``whole`` are partial sums
    over the mesh dims that shard the rows.  Plain tensors go straight
    through."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils._pytree import tree_map

    x = rows[0]
    if not isinstance(x, DTensor):
        return fn(rows, whole)
    mesh, pl = x.device_mesh, tuple(x.placements)
    if (any(tuple(r.placements) != pl for r in rows)
            or any(any(not isinstance(p, Replicate) for p in w.placements) for w in whole)):
        raise ValueError(f"by_rows needs row-sharded rows laid out alike and replicated "
                         f"weights, got {[r.placements for r in rows]} and "
                         f"{[w.placements for w in whole]}")
    grad_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    out = fn([r.to_local() for r in rows], [w.to_local(grad_placements=grad_pl) for w in whole])

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape) if t.is_contiguous()
                                  else None)

    return tree_map(wrap, out)


def select_row(x, dim: int, index: int):
    """``x.select(dim, index)``.  On a ``DTensor`` sharded along ``dim`` the
    chip that holds the row gives it and the others zeros, summed across
    them (a broadcast of one row, not a gather of the whole tensor)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if not isinstance(x, DTensor) or Shard(dim) not in x.placements:
        return x.select(dim, index)
    shape, offset = local_shape_offset(x.shape, x.device_mesh, x.placements)
    xl = x.to_local()
    if offset[dim] <= index < offset[dim] + shape[dim]:
        row = xl.select(dim, index - offset[dim])
    else:
        row = xl.select(dim, 0).new_zeros(xl.select(dim, 0).shape)
    pl = [Partial() if p == Shard(dim) else
          (Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > dim else p)
          for p in x.placements]
    out_shape = tuple(x.shape[:dim]) + tuple(x.shape[dim + 1:])
    return DTensor.from_local(row, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(out_shape), stride=contiguous_stride(out_shape))


def from_local(local: torch.Tensor, mesh, placements, shape):
    """A ``DTensor`` of global ``shape`` (contiguous strides) over this
    rank's ``local`` shard, placed by ``placements`` on ``mesh``: no check
    and no collective."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# Rule tables for the production shapes.
# ---------------------------------------------------------------------------

def make_rules(
    mesh,
    mode: str,
    *,
    multi_pod: bool = False,
    batch_size: int = 0,
    hmp_sequence_parallel: bool = True,
    serve_weights_model_only: bool = False,
) -> Rules:
    """The logical -> mesh table for an execution mode.

    mode: "train" | "prefill" | "decode" | "decode_long".
    ``hmp_sequence_parallel=False`` gives the Megatron-TP baseline layout
    (connective blocks replicated: the redundant-compute baseline the paper
    compares against).  ``serve_weights_model_only=True`` drops the FSDP
    (data-axis) shard of the weights in the serving modes: weights live
    model-sharded only, with no per-step weight AllGather, at the cost of
    num_data_shards x weight memory.
    """
    dp: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    m = "model"

    mapping: Dict[str, MeshAxes] = {
        # weights
        "embed_w": "data",        # FSDP shard of the embedding/contraction dim
        "heads_w": m,
        "kv_heads_w": m,
        "ffn_w": m,
        "experts_w": m,
        "vocab_w": m,
        "lru_w": m,
        "inner_w": m,
        # activations
        "batch": dp,
        "embed": None,
        "heads": m,
        "kv_heads": m,
        "ffn": m,
        "experts": m,
        "vocab": m,
        "lru": m,
        "inner": m,
        "img_seq": None,
        "expert_group": dp,
    }

    if mode == "train" or mode == "prefill":
        mapping["seq"] = m if hmp_sequence_parallel else None
        mapping["kv_seq"] = None
    elif mode == "decode":
        # one-token step: SP is vacuous; the KV cache is sharded along the
        # sequence and attention runs flash-decoding style (q and scores
        # replicated over the model axis, softmax reductions across it), so
        # the activation `heads` must not claim the model axis
        mapping["seq"] = None
        mapping["kv_seq"] = m
        mapping["heads"] = None
        mapping["kv_heads"] = None
    elif mode == "decode_long":
        # batch 1: the batch axes are vacuous; the cache is context-parallel
        # over the data axis as well as the model axis
        mapping["batch"] = None
        mapping["seq"] = None
        mapping["kv_seq"] = ("pod", "data", m) if multi_pod else ("data", m)
        mapping["heads"] = None
        mapping["kv_heads"] = None
        mapping["expert_group"] = None
    else:
        raise ValueError(f"unknown mode {mode}")

    if batch_size == 1:
        mapping["batch"] = None

    if serve_weights_model_only and mode in ("prefill", "decode", "decode_long"):
        mapping["embed_w"] = None

    return Rules(mapping=mapping, mesh=mesh)
