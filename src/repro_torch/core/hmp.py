"""Hybrid Model Parallelism (paper §III-B) over a ring of devices.

The paper's Fig. 5 on a post-LN Transformer layer (Fig. 2): TP over heads
(MHA) and FFN columns (MLP), SP over the connective blocks, a
ReduceScatter exiting each TP block and an AllGather entering it, each
fused with its adjacent GEMM as a tile ring (``core/ring.py``).

The D devices of an :class:`~repro_torch.core.execplan.ExecPlan` are the
devices of a ring (``core/ring.py``): a
:class:`~repro_torch.core.ring.LocalRing` holds all D in one process, a
:class:`~repro_torch.core.ring.ProcessRing` one per process.  Every
per-device quantity is a list over ``ring.devices``, the devices this
process holds, and each phase runs the body of each held device in turn;
the collectives (ring hops, the decode all-reduce, the gathers) are the
ring's, so the same program runs on either ring and no branch depends on
the rank.  The plan's uneven head/column counts are materialized as shards
padded to ``max(units)`` with zero weights, and its uneven sequence tiles
as a padded ragged layout (``SeqLayout``): real rows at per-device
offsets, pad rows masked out of the ring and the attention, K/V written to
the cache at *absolute* positions so decode never sees the padding.

``ExecPlan.compute_backend``: ``"eager"`` runs the padded shards as masked
dense PyTorch ops (every device executes ``max(units)`` work, the
correctness oracle); ``"kernel"`` routes every shard GEMM, the prefill
attention and both connective blocks through the hand-written kernels of
``kernels/``, which skip pad blocks.  The decode attention core (a
block-table gather and a masked softmax), the decode-path layernorms and
GELU stay plain PyTorch, as the reference leaves them to XLA.

Serving path: ``hmp_prefill`` runs a stack of layers over a prompt and
``hmp_decode`` is the single-token TP step, against either cache kind: the
dense per-wave cache of ``make_kv_cache`` (the wave protocol), or the
paged pool it builds as (pages, page size) with ``block_row=`` /
``block_table=`` (continuous batching).  ``hmp_prefill(offset=)`` is the
chunked / suffix-only prefill: a chunk at an absolute offset attends back
to the pages already written by a shared prefix and earlier chunks.  That
context attention stays plain PyTorch, as it stays XLA in the reference.

Baselines (paper §IV): ``megatron_layer`` (TP with an all-reduce after each
block, connectives repeated on every device) and ``sp_layer`` (weights
replicated, K and V all-gathered); ``SCHEDULES`` names all four.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.execplan import ExecPlan, SeqLayout
from repro_torch.core.ring import (
    Ring,
    RingSchedule,
    matmul_ring_reducescatter,
    ring_allgather_matmul,
    sync_allgather_matmul,
    sync_matmul_reducescatter,
)
from repro_torch.kernels import ops

NEG_INF = -1e30

_LN = ("ln1_s", "ln1_b", "ln2_s", "ln2_b")


# --- paper-style layer (Fig. 2): post-LN MHA + MLP --------------------------

def init_layer_params(d_model: int, num_heads: int, d_ff: int, *,
                      generator: torch.Generator, device=None,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Random layer params in the reference layout (normal * 0.02 weights,
    unit LN scale, zero LN bias), drawn from ``generator``."""
    hd = d_model // num_heads
    device = generator.device if device is None else device

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    return {
        "wq": normal(d_model, num_heads, hd),
        "wk": normal(d_model, num_heads, hd),
        "wv": normal(d_model, num_heads, hd),
        "wo": normal(num_heads, hd, d_model),
        "w1": normal(d_model, d_ff),
        "w2": normal(d_ff, d_model),
        "ln1_s": torch.ones(d_model, device=device, dtype=dtype),
        "ln1_b": torch.zeros(d_model, device=device, dtype=dtype),
        "ln2_s": torch.ones(d_model, device=device, dtype=dtype),
        "ln2_b": torch.zeros(d_model, device=device, dtype=dtype),
    }


def init_stack_params(num_layers: int, d_model: int, num_heads: int,
                      d_ff: int, *, generator: torch.Generator, device=None,
                      dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    return [init_layer_params(d_model, num_heads, d_ff, generator=generator,
                              device=device, dtype=dtype)
            for _ in range(num_layers)]


def params_from_numpy(layers: Sequence[Dict], embed, *, device=None,
                      dtype=torch.float32):
    """The reference's ``init_stack_params`` pytrees (as numpy arrays, in
    reference layout) and embedding table -> this package's tensors."""
    def conv(a):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return ([{k: conv(v) for k, v in p.items()} for p in layers], conv(embed))


def _ln(x, s, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * s + b).to(x.dtype)


def _gelu(x):
    # the reference's jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _attention(q, k, v, mask=None):
    """q, k, v: (B, S, H, hd) -> (B, S, H, hd).  ``mask`` overrides the
    plain causal mask (a ragged layout's padded-domain causality)."""
    hd = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(hd)
    s, t = scores.shape[-2], scores.shape[-1]
    if mask is None:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def reference_layer(p: Dict, x):
    """Single-device oracle of the paper's Fig. 2 layer (post-LN)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    attn = _attention(q, k, v)
    g = torch.einsum("bshk,hkd->bsd", attn, p["wo"])
    x = _ln(x + g, p["ln1_s"], p["ln1_b"])
    h = _gelu(torch.einsum("bsd,df->bsf", x, p["w1"]))
    f = torch.einsum("bsf,fd->bsd", h, p["w2"])
    return _ln(x + f, p["ln2_s"], p["ln2_b"])


def reference_stack(layers: Sequence[Dict], x):
    for p in layers:
        x = reference_layer(p, x)
    return x


# --- per-device shards ----------------------------------------------------------

def shard_layer_params(plan: ExecPlan, p: Dict,
                       devices: Optional[Sequence[int]] = None) -> List[Dict[str, torch.Tensor]]:
    """Reference- or padded-layout layer params -> one dict per device of
    ``devices`` (default: all of the plan's).

    Device ``d`` gets its padded head slots as a fused ``wqkv`` (d_model,
    3 * pad_heads * hd) — three column segments q | k | v, each with the
    device's real heads as the valid prefix — its ``wo`` rows (pad_heads *
    hd, d_model), and its padded ``w1`` columns / ``w2`` rows; the LN
    params are shared.  Every tensor is contiguous, and a subset of the
    devices holds copies only (no view keeps the whole layer alive)."""
    p = plan.ensure_padded(p)
    d_model = p["wq"].shape[0]
    ph, pc, hd = plan.pad_heads, plan.pad_columns, plan.head_dim
    devices = range(plan.num_devices) if devices is None else devices
    own = len(devices) < plan.num_devices
    shards = []
    for i in devices:
        hs, cs = slice(i * ph, (i + 1) * ph), slice(i * pc, (i + 1) * pc)
        shard = {
            "wqkv": torch.cat([p[n][:, hs].reshape(d_model, ph * hd)
                               for n in ("wq", "wk", "wv")], dim=1),
            "wo": p["wo"][hs].reshape(ph * hd, d_model).contiguous(),
            "w1": p["w1"][:, cs].contiguous(),
            "w2": p["w2"][cs].contiguous(),
        }
        shard.update({n: p[n] for n in _LN})
        if own:
            shard = {n: t.clone() for n, t in shard.items()}
        shards.append(shard)
    return shards


def _as_shards(plan: ExecPlan, p, ring: Ring) -> List[Dict[str, torch.Tensor]]:
    """Accept the held devices' shards (from ``shard_layer_params``) or a
    layer dict in reference/padded layout."""
    if isinstance(p, (list, tuple)):
        if len(p) != len(ring.devices):
            raise ValueError(f"{len(p)} layer shards for the {len(ring.devices)} "
                             "devices this process holds")
        return p
    return shard_layer_params(plan, p, ring.devices)


class _KernelCompute:
    """Per-device kernel bindings (``compute_backend="kernel"``), the
    counterpart of the reference's ``_PallasCompute``.

    The device's valid head/column counts are host ints, so every launch
    knows its valid extents without a device sync and the kernels skip
    tiles that are entirely padding.  The GEMM methods double as the ring
    primitives' per-tile hooks (``valid_rows`` is the held tile's real row
    count in ring order)."""

    def __init__(self, plan: ExecPlan, device: int,
                 positions: Optional[np.ndarray]):
        self.hd = plan.head_dim
        self.pad_heads = plan.pad_heads
        self.valid_heads = plan.heads[device]
        self.valid_cols = plan.columns[device]
        self.positions = positions  # padded row -> real position (static)

    def qkv_gemm(self, tile, w, valid_rows=None):
        # w = [wq | wk | wv]: three column segments, each a padded head slot
        # block with this device's real heads as the valid prefix
        return ops.gemm(tile, w, backend="kernel", valid_m=valid_rows,
                        valid_n=self.valid_heads * self.hd,
                        seg_n=self.pad_heads * self.hd)

    def wo_gemm(self, tile, w, valid_rows=None):
        return ops.gemm(tile, w, backend="kernel", valid_m=valid_rows,
                        valid_k=self.valid_heads * self.hd)

    def w1_gemm(self, tile, w, valid_rows=None):
        return ops.gemm(tile, w, backend="kernel", valid_m=valid_rows,
                        valid_n=self.valid_cols)

    def w2_gemm(self, tile, w, valid_rows=None):
        return ops.gemm(tile, w, backend="kernel", valid_m=valid_rows,
                        valid_k=self.valid_cols)

    def attention(self, q, k, v):
        """(B, S, H, hd) ragged flash attention: pad rows and pad head
        slots are skipped and come out exactly zero."""
        return ops.ragged_attention(q, k, v, positions=self.positions,
                                    valid_heads=self.valid_heads)


def _make_compute(plan: ExecPlan, ring: Ring, layout: Optional[SeqLayout],
                  seq_total: Optional[int]) -> Optional[List[_KernelCompute]]:
    if plan.compute_backend != "kernel":
        return None
    if layout is not None:
        positions = layout.positions
    elif seq_total is not None:
        positions = np.arange(seq_total)
    else:
        positions = None  # decode: attention stays on the gather path
    return [_KernelCompute(plan, i, positions) for i in ring.devices]


def _hook(computes: Optional[List[_KernelCompute]], name: str):
    if computes is None:
        return None
    return lambda j, tile, w, valid: getattr(computes[j], name)(tile, w, valid)


def _local_mask(layout: Optional[SeqLayout], s: int, device) -> torch.Tensor:
    """(s, s) causal mask of a chunk's own rows: the ragged layout's
    padded-domain causality, or the plain triangle for a dense one."""
    if layout is not None:
        return layout.on("mask", device)
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def _ctx_attention(q, k, v, ctx_k, ctx_v, offset, local_mask):
    """Chunked-prefill attention: the chunk's queries attend to context
    keys at absolute positions below ``offset`` (shared prefix pages and
    earlier chunks) plus the chunk's own K/V under ``local_mask``.

    q, k, v: (1, S, H, hd); ctx_k, ctx_v: (T, H, hd) gathered over absolute
    positions [0, T); ``offset`` a host int or a 0-dim tensor on the
    device (compared there).  Positions ``>= offset`` of the context are
    masked, so stale rows contribute exact zeros after the softmax and the
    chunk's own keys enter once, from the fresh K/V.  Every context key
    precedes every real chunk query (ctx_pos < offset <= q_pos), so the
    local part keeps the chunk's relative causality."""
    s, t = q.shape[1], ctx_k.shape[0]
    ctx_mask = (torch.arange(t, device=q.device) < offset)[None, :].expand(s, t)
    mask = torch.cat([ctx_mask, local_mask], dim=1)
    kf = torch.cat([ctx_k[None].to(k.dtype), k], dim=1)
    vf = torch.cat([ctx_v[None].to(v.dtype), v], dim=1)
    return _attention(q, kf, vf, mask=mask)


def _hmp_layer_body(ps: List[Dict], xs: List[torch.Tensor], ring: Ring, *,
                    plan: ExecPlan, overlap: bool,
                    layout: Optional[SeqLayout] = None, ctx=None):
    """One layer on every held ring device.  xs[j]: (B, S_loc, d) sequence
    shard of device ``ring.devices[j]``; ps[j] its head/column shards.  TP
    blocks see the full sequence, connective blocks the local shard (paper
    Fig. 5).  Returns the output shards and each held device's K/V head
    shards over the full (padded) sequence.

    ``layout`` (a *ragged* SeqLayout; dense layouts pass None) drives the
    uneven-SP masking: the ring primitives zero pad rows per step and the
    attention masks pad keys, so garbage in pad rows stays in pad rows.

    ``ctx = (ctx_ks, ctx_vs, offset)`` (chunked prefill): held device j's
    queries also attend to its context K/V ``ctx_ks[j]``/``ctx_vs[j]``
    (``_ctx_attention``).  That attention is plain PyTorch under either
    backend; the ring GEMMs and connectives still go through the kernels."""
    ag_mm = ring_allgather_matmul if overlap else sync_allgather_matmul
    mm_rs = matmul_ring_reducescatter if overlap else sync_matmul_reducescatter
    d = ring.num_devices
    s_loc = xs[0].shape[1]
    ph, hd = plan.pad_heads, plan.head_dim
    if layout is not None:
        base = plan.ring_schedule(layout=layout)
    else:
        base = RingSchedule.dense(d, s_loc, transport=plan.transport,
                                  double_buffer=plan.double_buffer)
    computes = _make_compute(plan, ring, layout, d * s_loc)
    # the padded_len^2 mask feeds the eager attention and a chunk's context
    # attention; the kernel derives its masking from layout.positions
    attn_mask = None
    if ctx is not None:
        attn_mask = _local_mask(layout, d * s_loc, xs[0].device)
    elif layout is not None and computes is None:
        attn_mask = layout.on("mask", xs[0].device)

    def sched(name):
        return base.with_gemm(_hook(computes, name))

    # ---- MHA block (TP over heads): AllGather ⊗ GEMM1 ----
    qkv = ag_mm(xs, [p["wqkv"] for p in ps], ring, schedule=sched("qkv_gemm"))
    attn, ks, vs = [], [], []
    for j, t in enumerate(qkv):
        shape = (*t.shape[:2], ph, hd)
        q, k, v = (u.reshape(shape) for u in t.split(ph * hd, dim=-1))
        if ctx is not None:
            a = _ctx_attention(q, k, v, ctx[0][j], ctx[1][j], ctx[2], attn_mask)
        elif computes is not None:
            a = computes[j].attention(q, k, v)
        else:
            a = _attention(q, k, v, mask=attn_mask)
        attn.append(a.reshape(*shape[:2], ph * hd))
        ks.append(k)
        vs.append(v)
    # GEMM ⊗ ReduceScatter
    g = mm_rs(attn, [p["wo"] for p in ps], ring, schedule=sched("wo_gemm"))

    # ---- connective block (SP over the local sequence shard) ----
    def connective(x, res, s, b):
        """``_ln(res + x)`` on every held device's shard; the kernel
        backend computes them in one fused launch (all D shards on a
        LocalRing, this rank's one on a ProcessRing)."""
        if computes is not None:
            return ops.connective_group(x, res, [p[s] for p in ps], [p[b] for p in ps])
        return [_ln(r + t, p[s], p[b]) for t, r, p in zip(x, res, ps)]

    y = connective(g, xs, "ln1_s", "ln1_b")

    # ---- MLP block (TP over columns) ----
    h = ag_mm(y, [p["w1"] for p in ps], ring, schedule=sched("w1_gemm"))
    h = [_gelu(t) for t in h]
    f = mm_rs(h, [p["w2"] for p in ps], ring, schedule=sched("w2_gemm"))
    out = connective(f, y, "ln2_s", "ln2_b")
    return out, ks, vs


def _resolve_layout(plan: ExecPlan, ring: Ring, x,
                    seq: Optional[int]) -> Optional[SeqLayout]:
    """The ragged layout of ``x`` under the plan; None for a dense one."""
    if plan.num_devices != ring.num_devices:
        raise ValueError(
            f"plan covers {plan.num_devices} devices but the ring has "
            f"{ring.num_devices}"
        )
    layout = plan.seq_layout(seq if seq is not None else x.shape[1])
    if x.shape[1] != layout.padded_len:
        raise ValueError(
            f"sequence of {x.shape[1]} rows does not match the plan's padded "
            f"ragged layout for seq={layout.seq} (tiles {list(layout.tiles)} "
            f"pad to {layout.padded_len} rows); scatter it with "
            f"plan.seq_layout(seq).scatter(x) and pass seq="
        )
    return None if layout.is_dense else layout


def _split_seq(x, ring: Ring) -> List[torch.Tensor]:
    """The held devices' sequence tiles of ``x`` (replicated on every
    process)."""
    t = x.shape[1] // ring.num_devices
    return [x[:, i * t:(i + 1) * t] for i in ring.devices]


def hmp_layer(p, x, ring: Ring, *, plan: ExecPlan, overlap: bool = False,
              seq: Optional[int] = None):
    """Galaxy HMP layer.  x: (B, S, d) global, in the plan's padded ragged
    layout for the logical length ``seq`` (``plan.seq_layout(seq).scatter
    (x)``) when that layout is ragged.  ``p`` is a layer dict in reference
    or padded layout, or per-device shards."""
    layout = _resolve_layout(plan, ring, x, seq)
    out, _, _ = _hmp_layer_body(_as_shards(plan, p, ring), _split_seq(x, ring), ring,
                                plan=plan, overlap=overlap, layout=layout)
    return ring.all_gather(out, dim=1)


# --- serving path: dense per-wave cache or paged pool ---------------------------

def make_kv_cache(batch: int, cache_len: int, num_layers: int, plan: ExecPlan, *,
                  device=None, dtype=torch.float32,
                  devices: Optional[Sequence[int]] = None) -> List[Dict[str, List[torch.Tensor]]]:
    """KV storage for a stack of HMP layers: the dense per-wave cache, or
    the paged pool.

    Each layer holds, per ring device of ``devices`` (default: all of the
    plan's; a ProcessRing's rank holds its own), k/v of shape (batch, cache_len,
    pad_heads, hd): the device's padded head slots, so shards line up with
    the weight shards and pad slots stay zero.  As the wave cache, rows are
    absolute positions, so cache_len only needs the longest bucketed prompt
    plus the decode steps.  As the paged pool, ``batch`` is the number of
    pages and ``cache_len`` the page size; page 0 is the null page
    (``serving/kvpool.py``): idle-slot writes land there and masked reads
    never see it."""
    shape = (batch, cache_len, plan.pad_heads, plan.head_dim)
    n = plan.num_devices if devices is None else len(devices)

    def shards():
        return [torch.zeros(shape, device=device, dtype=dtype) for _ in range(n)]

    return [{"k": shards(), "v": shards()} for _ in range(num_layers)]


def reset_kv_cache(cache: List[Dict[str, List[torch.Tensor]]]) -> None:
    """Zero a :func:`make_kv_cache` tree in place: bitwise a fresh one,
    with every tensor where it was (a wave cache reused by the next wave:
    a stale non-finite V entry would turn masked attention into NaN)."""
    for layer in cache:
        for shards in layer.values():
            for t in shards:
                t.zero_()


def hmp_prefill(layers: Sequence, x, ring: Ring, cache: List[Dict], *,
                plan: ExecPlan, overlap: bool = False, seq: Optional[int] = None,
                block_row=None, offset=None):
    """Run a stack of HMP layers over a prompt, writing its K/V into the
    cache at absolute positions.

    x: (B, S, d), in the plan's padded ragged layout of a ``seq``-row
    sequence when that is ragged.  The knobs compose as in the reference:

    * cache kind — ``cache`` is the dense per-wave cache of
      ``make_kv_cache`` by default; ``block_row=`` (the request's physical
      pages, ``(pages_per_slot,)``) makes it the paged pool and K/V scatter
      straight into pages (batch 1).
    * ``offset=`` — chunked / suffix-only prefill (paged only): ``x`` is one
      chunk at absolute positions [offset, offset + seq), attending back to
      every written position below ``offset``; a host int, or a 0-dim
      tensor on the device, the reference's traced scalar (one captured
      program for every offset; the caller checks the bounds).

    Pad rows of a ragged layout never touch the cache; bucket-padding
    positions past the real prompt write zero-token K/V that decode
    overwrites before reading.  The cache is updated in place.  Returns
    (y, cache), y in x's layout."""
    if block_row is None:
        if offset is not None:
            raise ValueError("offset= (chunked prefill) needs a paged cache; pass "
                             "the request's block_row= as well")
        return _prefill_dense(layers, x, ring, cache, plan=plan, overlap=overlap,
                              seq=seq)
    return _prefill_paged(layers, x, ring, cache, block_row, plan=plan,
                          overlap=overlap, seq=seq, offset=offset)


def _prefill_dense(layers: Sequence, x, ring: Ring, cache: List[Dict], *,
                   plan: ExecPlan, overlap: bool, seq: Optional[int]):
    layout = _resolve_layout(plan, ring, x, seq)
    s = x.shape[1] if layout is None else layout.seq
    rows = None if layout is None else layout.on("rows", x.device)
    xs = _split_seq(x, ring)
    for p, c in zip(layers, cache):
        xs, ks, vs = _hmp_layer_body(_as_shards(plan, p, ring), xs, ring, plan=plan,
                                     overlap=overlap, layout=layout)
        for j, (k, v) in enumerate(zip(ks, vs)):
            if rows is not None:
                k, v = k[:, rows], v[:, rows]
            c["k"][j][:, :s] = k
            c["v"][j][:, :s] = v
    return ring.all_gather(xs, dim=1), cache


def _prefill_paged(layers: Sequence, x, ring: Ring, pages: List[Dict],
                   block_row, *, plan: ExecPlan, overlap: bool,
                   seq: Optional[int], offset):
    """Paged-pool prefill (see ``hmp_prefill``).  With ``offset`` each
    layer first gathers every held device's context K/V from its own pool
    shard (the whole block row, only the device's valid head slots, as the
    reference gathers it; positions from the offset on are masked in
    ``_ctx_attention``), then runs the chunk, then scatters the chunk's
    K/V: the gather comes before the scatter, so the chunk's own keys
    enter the attention once.

    ``offset`` is a host int, checked here, or a 0-dim integer tensor on
    the device, which nothing here reads on the host: one program then
    serves every offset, and the caller checks ``offset + S <= W x page``
    (``serving/galaxy.py:prefill_chunk``)."""
    if x.shape[0] != 1:
        raise ValueError("paged prefill is per-request: batch must be 1")
    layout = _resolve_layout(plan, ring, x, seq)
    s = x.shape[1] if layout is None else layout.seq
    page_size = pages[0]["k"][0].shape[1]
    block_row = torch.as_tensor(block_row, device=x.device).long()
    base = 0 if offset is None else offset
    if not isinstance(base, torch.Tensor):
        base = int(base)
        if base < 0:
            raise ValueError(f"offset must be >= 0, got {base}")
        if base + s > block_row.shape[0] * page_size:
            raise ValueError(
                f"positions [{base}, {base + s}) exceed the block row "
                f"({block_row.shape[0]} pages x {page_size})"
            )
    pos = base + torch.arange(s, device=x.device)
    phys = block_row[pos // page_size]
    within = pos % page_size
    rows = None if layout is None else layout.on("rows", x.device)
    if offset is not None:
        head_ok = [torch.arange(plan.pad_heads, device=x.device) < plan.heads[i]
                   for i in ring.devices]
    xs = _split_seq(x, ring)
    for p, c in zip(layers, pages):
        ctx = None
        if offset is not None:
            ctx = ([_paged_kv_gather(k, block_row[None], ok)[0]
                    for k, ok in zip(c["k"], head_ok)],
                   [_paged_kv_gather(v, block_row[None], ok)[0]
                    for v, ok in zip(c["v"], head_ok)],
                   base)
        xs, ks, vs = _hmp_layer_body(_as_shards(plan, p, ring), xs, ring, plan=plan,
                                     overlap=overlap, layout=layout, ctx=ctx)
        for j, (k, v) in enumerate(zip(ks, vs)):
            k, v = k[0], v[0]
            if rows is not None:
                k, v = k[rows], v[rows]
            c["k"][j][phys, within] = k
            c["v"][j][phys, within] = v
    return ring.all_gather(xs, dim=1), pages


def _paged_kv_gather(pool, block_table, head_ok):
    """Block-table gather reading only the valid head slots of real pages.

    pool: (P, page, H, hd); block_table: (S, W); head_ok: (H,) bool — which
    padded head slots hold this device's real heads.  Pad head slots' reads
    are routed to the null page 0, whose pad-head entries stay zero (the
    projections of zero weights), so the result equals the whole-page
    gather while only the valid slots of live pages are touched.
    Returns (S, W*page, H, hd)."""
    s, w = block_table.shape
    page, h, hd = pool.shape[1], pool.shape[2], pool.shape[3]
    bt = torch.where(head_ok[None, None, :], block_table[:, :, None],
                     torch.zeros((), dtype=block_table.dtype,
                                 device=block_table.device))
    heads = torch.arange(h, device=pool.device)[None, None, :]
    # advanced indices at axes 0 and 2 broadcast to (S, W, H) and land in
    # front of the kept axes: (S, W, H, page, hd)
    out = pool[bt, :, heads, :]
    return out.permute(0, 1, 3, 2, 4).reshape(s, w * page, h, hd)


def _decode_qkv(p, x, compute: Optional[_KernelCompute], ph: int, hd: int):
    """(B, S, d) -> q, k, v (B, S, ph, hd) through the backend (the fused
    QKV projection shared by decode and the Megatron baseline)."""
    qkv = (compute.qkv_gemm(x, p["wqkv"]) if compute is not None
           else torch.matmul(x, p["wqkv"]))
    shape = (*x.shape[:2], ph, hd)
    return (t.reshape(shape) for t in qkv.split(ph * hd, dim=-1))


def _tp_exit(ps: List[Dict], x, gs: List[torch.Tensor],
             computes: Optional[List[_KernelCompute]], ring: Ring):
    """The tail of a replicated-x TP layer (decode, Megatron): the MHA
    block's partial outputs ``gs`` exit through an all-reduce, then the
    connective, the TP MLP (all-reduce exit) and the second connective,
    each connective computed once on the replicated rows."""
    p0 = ps[0]
    x = _ln(x + ring.psum(gs), p0["ln1_s"], p0["ln1_b"])
    fs = []
    for j, p in enumerate(ps):
        comp = None if computes is None else computes[j]
        if comp is not None:
            fs.append(comp.w2_gemm(_gelu(comp.w1_gemm(x, p["w1"])), p["w2"]))
        else:
            fs.append(torch.matmul(_gelu(torch.matmul(x, p["w1"])), p["w2"]))
    return _ln(x + ring.psum(fs), p0["ln2_s"], p0["ln2_b"])


def _decode_layer(ps: List[Dict], x, kv_step, valid, *, plan: ExecPlan,
                  ring: Ring):
    """Single-token TP step of one layer on every held ring device.

    x: (S, 1, d) replicated slot batch.  ``kv_step(j, k_new, v_new)``
    writes held device j's new K/V head shard into its cache and returns the
    keys and values each slot attends to, (S, T, ph, hd); ``valid`` (S, T)
    masks them by slot length.  The TP blocks exit through an all-reduce,
    and the connective blocks run once on the replicated result (the SP
    axis is degenerate at one token).  The projections go through the
    backend; the attention core is plain PyTorch."""
    computes = _make_compute(plan, ring, None, None)
    ph, hd = plan.pad_heads, plan.head_dim
    s = x.shape[0]
    gs = []
    for j, p in enumerate(ps):
        comp = None if computes is None else computes[j]
        q, k_new, v_new = _decode_qkv(p, x, comp, ph, hd)
        ks, vs = kv_step(j, k_new[:, 0], v_new[:, 0])
        scores = torch.einsum("bqhd,bthd->bhqt", q, ks).float() / math.sqrt(hd)
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full((), NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(vs.dtype)
        attn = torch.einsum("bhqt,bthd->bqhd", probs, vs).reshape(s, 1, ph * hd)
        gs.append(comp.wo_gemm(attn, p["wo"]) if comp is not None
                  else torch.matmul(attn, p["wo"]))
    return _tp_exit(ps, x, gs, computes, ring)


def hmp_decode(layers: Sequence, x, ring: Ring, cache: List[Dict],
               positions, *, plan: ExecPlan, block_table=None):
    """One decode step for a stack of HMP layers.

    x: (S, 1, d) current-token embeddings; positions: (S,) absolute
    position each row writes this step (a host int broadcasts).  Against
    the dense cache (default) row b is cache row b; ``block_table=`` (S, W)
    makes ``cache`` the paged pool of a continuous-batching slot batch,
    physical page per (slot, logical page), idle slots carrying all-null
    rows (their write lands in the null page and every null read is
    masked).  Each row writes its entry before attending, so bucket
    padding is never read.  The cache is updated in place.  Returns (y,
    cache) with y (S, 1, d)."""
    if plan.num_devices != ring.num_devices:
        raise ValueError(
            f"plan covers {plan.num_devices} devices but the ring has "
            f"{ring.num_devices}"
        )
    s = x.shape[0]
    positions = torch.as_tensor(positions, device=x.device).long()
    if positions.dim() == 0:
        positions = positions.expand(s)
    rows = torch.arange(s, device=x.device)
    if block_table is None:
        t = cache[0]["k"][0].shape[1]
    else:
        block_table = torch.as_tensor(block_table, device=x.device).long()
        page_size = cache[0]["k"][0].shape[1]
        t = block_table.shape[1] * page_size
        phys = block_table[rows, positions // page_size]
        within = positions % page_size
        head_ok = [torch.arange(plan.pad_heads, device=x.device) < plan.heads[i]
                   for i in ring.devices]
    valid = torch.arange(t, device=x.device)[None, :] <= positions[:, None]
    for p, c in zip(layers, cache):
        if block_table is None:
            def kv_step(j, k_new, v_new, c=c):
                c["k"][j][rows, positions] = k_new
                c["v"][j][rows, positions] = v_new
                return c["k"][j], c["v"][j]
        else:
            def kv_step(j, k_new, v_new, c=c):
                c["k"][j][phys, within] = k_new
                c["v"][j][phys, within] = v_new
                # read only this device's valid head slots of live pages;
                # pad slots route to the (zero) null page
                return (_paged_kv_gather(c["k"][j], block_table, head_ok[j]),
                        _paged_kv_gather(c["v"][j], block_table, head_ok[j]))
        x = _decode_layer(_as_shards(plan, p, ring), x, kv_step, valid, plan=plan,
                          ring=ring)
    return x, cache


# --- baselines (paper §IV): Megatron-LM TP and pure sequence parallelism -------

def _even_plan(p: Dict, ring: Ring) -> ExecPlan:
    """The equal split of a reference-layout layer over the ring."""
    return ExecPlan.even(ring.num_devices, num_heads=p["wq"].shape[1],
                         d_ff=p["w1"].shape[1], head_dim=p["wq"].shape[2],
                         d_model=p["wq"].shape[0])


def megatron_layer(p, x, ring: Ring, *, plan: Optional[ExecPlan] = None):
    """Megatron-LM TP baseline.  x: (B, S, d) replicated on every device;
    each device runs its head and column shards over the whole sequence,
    each block exits through an all-reduce, and the connective blocks run
    redundantly on every device (the waste HMP removes).  Without a plan
    the heads and columns split evenly; under the kernel backend the GEMMs
    shed pad blocks and the attention is the ragged flash kernel over the
    dense sequence."""
    if plan is None:
        plan = _even_plan(p, ring)
    if plan.num_devices != ring.num_devices:
        raise ValueError(f"plan covers {plan.num_devices} devices but the ring "
                         f"has {ring.num_devices}")
    ps = _as_shards(plan, p, ring)
    computes = _make_compute(plan, ring, None, x.shape[1])
    ph, hd = plan.pad_heads, plan.head_dim
    gs = []
    for j, sh in enumerate(ps):
        comp = None if computes is None else computes[j]
        q, k, v = _decode_qkv(sh, x, comp, ph, hd)
        if comp is not None:
            attn = comp.attention(q, k, v).reshape(*x.shape[:2], ph * hd)
            gs.append(comp.wo_gemm(attn, sh["wo"]))
        else:
            attn = _attention(q, k, v).reshape(*x.shape[:2], ph * hd)
            gs.append(torch.matmul(attn, sh["wo"]))
    return _tp_exit(ps, x, gs, computes, ring)


def sp_layer(p: Dict, x, ring: Ring, *, plan: Optional[ExecPlan] = None):
    """Pure sequence-parallelism baseline.  x: (B, S, d) split evenly over
    the ring's devices; the weights (reference layout) are replicated on
    each (the memory wall), and K and V need the whole sequence: two
    all-gathers per MHA block (paper §IV-A).  Plain PyTorch under any
    backend, as in the reference.  An uneven TP plan does not apply: a
    plan only has to cover the ring."""
    d = ring.num_devices
    if plan is not None and plan.num_devices != d:
        raise ValueError(f"plan covers {plan.num_devices} devices but the ring "
                         f"has {d}")
    if x.shape[1] % d:
        raise ValueError(f"sequence of {x.shape[1]} rows does not split evenly "
                         f"over {d} devices")
    xs = _split_seq(x, ring)
    s_loc = xs[0].shape[1]
    qs = [torch.einsum("bsd,dhk->bshk", t, p["wq"]) for t in xs]
    k = ring.all_gather([torch.einsum("bsd,dhk->bshk", t, p["wk"]) for t in xs], dim=1)
    v = ring.all_gather([torch.einsum("bsd,dhk->bshk", t, p["wv"]) for t in xs], dim=1)
    k_pos = torch.arange(k.shape[1], device=x.device)
    outs = []
    for i, xl, q in zip(ring.devices, xs, qs):
        # causal offset of the local query block
        q_pos = i * s_loc + torch.arange(s_loc, device=x.device)
        attn = _attention(q, k, v, mask=k_pos[None, :] <= q_pos[:, None])
        g = torch.einsum("bshk,hkd->bsd", attn, p["wo"])
        xl = _ln(xl + g, p["ln1_s"], p["ln1_b"])
        h = _gelu(torch.einsum("bsd,df->bsf", xl, p["w1"]))
        f = torch.einsum("bsf,fd->bsd", h, p["w2"])
        outs.append(_ln(xl + f, p["ln2_s"], p["ln2_b"]))
    return ring.all_gather(outs, dim=1)


SCHEDULES = {
    "hmp": lambda p, x, ring, **kw: hmp_layer(p, x, ring, overlap=False, **kw),
    "hmp_ring": lambda p, x, ring, **kw: hmp_layer(p, x, ring, overlap=True, **kw),
    "megatron": lambda p, x, ring, **kw: megatron_layer(p, x, ring, **kw),
    "sp": lambda p, x, ring, **kw: sp_layer(p, x, ring, **kw),
}
