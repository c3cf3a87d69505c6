"""Hybrid Model Parallelism (paper §III-B) over a single-process ring.

The paper's Fig. 5 on a post-LN Transformer layer (Fig. 2): TP over heads
(MHA) and FFN columns (MLP), SP over the connective blocks, a
ReduceScatter exiting each TP block and an AllGather entering it, each
fused with its adjacent GEMM as a tile ring (``core/ring.py``).

The D devices of an :class:`~repro_torch.core.execplan.ExecPlan` are the
shards of a :class:`~repro_torch.core.ring.LocalRing`: every per-device
quantity is a list of D tensors, each phase runs every device's body in
turn, ring hops are device copies and the decode all-reduce is a sum over
shards.  The plan's uneven head/column counts are materialized as shards
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

Serving path: ``hmp_prefill(block_row=)`` runs a stack of layers over one
prompt and scatters its K/V straight into paged-pool pages;
``hmp_decode(block_table=)`` is the single-token TP step of a slot batch
against those pages.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.execplan import ExecPlan, SeqLayout
from repro_torch.core.ring import (
    LocalRing,
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

def shard_layer_params(plan: ExecPlan, p: Dict) -> List[Dict[str, torch.Tensor]]:
    """Reference- or padded-layout layer params -> one dict per device.

    Device ``d`` gets its padded head slots as a fused ``wqkv`` (d_model,
    3 * pad_heads * hd) — three column segments q | k | v, each with the
    device's real heads as the valid prefix — its ``wo`` rows (pad_heads *
    hd, d_model), and its padded ``w1`` columns / ``w2`` rows; the LN
    params are shared.  Every tensor is contiguous."""
    p = plan.ensure_padded(p)
    d_model = p["wq"].shape[0]
    ph, pc, hd = plan.pad_heads, plan.pad_columns, plan.head_dim
    shards = []
    for i in range(plan.num_devices):
        hs, cs = slice(i * ph, (i + 1) * ph), slice(i * pc, (i + 1) * pc)
        shard = {
            "wqkv": torch.cat([p[n][:, hs].reshape(d_model, ph * hd)
                               for n in ("wq", "wk", "wv")], dim=1),
            "wo": p["wo"][hs].reshape(ph * hd, d_model).contiguous(),
            "w1": p["w1"][:, cs].contiguous(),
            "w2": p["w2"][cs].contiguous(),
        }
        shard.update({n: p[n] for n in _LN})
        shards.append(shard)
    return shards


def _as_shards(plan: ExecPlan, p) -> List[Dict[str, torch.Tensor]]:
    """Accept per-device shards (from ``shard_layer_params``) or a layer
    dict in reference/padded layout."""
    return p if isinstance(p, (list, tuple)) else shard_layer_params(plan, p)


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

    def connective(self, x, res, scale, bias):
        """Fused residual + layernorm (one pass) == ``_ln(res + x)``."""
        return ops.connective(x, res, scale, bias)


def _make_compute(plan: ExecPlan, layout: Optional[SeqLayout],
                  seq_total: Optional[int]) -> Optional[List[_KernelCompute]]:
    if plan.compute_backend != "kernel":
        return None
    if layout is not None:
        positions = layout.positions
    elif seq_total is not None:
        positions = np.arange(seq_total)
    else:
        positions = None  # decode: attention stays on the gather path
    return [_KernelCompute(plan, i, positions) for i in range(plan.num_devices)]


def _hook(computes: Optional[List[_KernelCompute]], name: str):
    if computes is None:
        return None
    return lambda dev, tile, w, valid: getattr(computes[dev], name)(tile, w, valid)


def _hmp_layer_body(ps: List[Dict], xs: List[torch.Tensor], ring: LocalRing, *,
                    plan: ExecPlan, overlap: bool,
                    layout: Optional[SeqLayout] = None):
    """One layer on every ring device.  xs[i]: (B, S_loc, d) sequence shard
    of device i; ps[i] its head/column shards.  TP blocks see the full
    sequence, connective blocks the local shard (paper Fig. 5).  Returns
    the output shards and each device's K/V head shards over the full
    (padded) sequence.

    ``layout`` (a *ragged* SeqLayout; dense layouts pass None) drives the
    uneven-SP masking: the ring primitives zero pad rows per step and the
    attention masks pad keys, so garbage in pad rows stays in pad rows."""
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
    computes = _make_compute(plan, layout, d * s_loc)
    # the padded_len^2 ragged mask feeds only the eager attention; the
    # kernel derives its masking from layout.positions
    attn_mask = None
    if layout is not None and computes is None:
        attn_mask = torch.as_tensor(layout.attention_mask(), device=xs[0].device)

    def sched(name):
        return base.with_gemm(_hook(computes, name))

    # ---- MHA block (TP over heads): AllGather ⊗ GEMM1 ----
    qkv = ag_mm(xs, [p["wqkv"] for p in ps], ring, schedule=sched("qkv_gemm"))
    attn, ks, vs = [], [], []
    for i in range(d):
        shape = (*qkv[i].shape[:2], ph, hd)
        q, k, v = (t.reshape(shape) for t in qkv[i].split(ph * hd, dim=-1))
        if computes is not None:
            a = computes[i].attention(q, k, v)
        else:
            a = _attention(q, k, v, mask=attn_mask)
        attn.append(a.reshape(*shape[:2], ph * hd))
        ks.append(k)
        vs.append(v)
    # GEMM ⊗ ReduceScatter
    g = mm_rs(attn, [p["wo"] for p in ps], ring, schedule=sched("wo_gemm"))

    # ---- connective block (SP over the local sequence shard) ----
    def connective(i, x, res, s, b):
        p = ps[i]
        if computes is not None:
            return computes[i].connective(x, res, p[s], p[b])
        return _ln(res + x, p[s], p[b])

    y = [connective(i, g[i], xs[i], "ln1_s", "ln1_b") for i in range(d)]

    # ---- MLP block (TP over columns) ----
    h = ag_mm(y, [p["w1"] for p in ps], ring, schedule=sched("w1_gemm"))
    h = [_gelu(t) for t in h]
    f = mm_rs(h, [p["w2"] for p in ps], ring, schedule=sched("w2_gemm"))
    out = [connective(i, f[i], y[i], "ln2_s", "ln2_b") for i in range(d)]
    return out, ks, vs


def _resolve_layout(plan: ExecPlan, ring: LocalRing, x,
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


def _split_seq(x, d: int) -> List[torch.Tensor]:
    t = x.shape[1] // d
    return [x[:, i * t:(i + 1) * t] for i in range(d)]


def hmp_layer(p, x, ring: LocalRing, *, plan: ExecPlan, overlap: bool = False,
              seq: Optional[int] = None):
    """Galaxy HMP layer.  x: (B, S, d) global, in the plan's padded ragged
    layout for the logical length ``seq`` (``plan.seq_layout(seq).scatter
    (x)``) when that layout is ragged.  ``p`` is a layer dict in reference
    or padded layout, or per-device shards."""
    layout = _resolve_layout(plan, ring, x, seq)
    out, _, _ = _hmp_layer_body(_as_shards(plan, p),
                                _split_seq(x, ring.num_devices), ring,
                                plan=plan, overlap=overlap, layout=layout)
    return torch.cat(out, dim=1)


# --- paged serving path: pool pages + block tables ----------------------------

def make_paged_kv_cache(num_pages: int, page_size: int, num_layers: int,
                        plan: ExecPlan, *, device=None,
                        dtype=torch.float32) -> List[Dict[str, List[torch.Tensor]]]:
    """Paged KV pool storage for a stack of HMP layers.

    Each layer holds, per ring device, k/v pages of shape (num_pages,
    page_size, pad_heads, hd): the device's padded head slots, so page
    shards line up with the weight shards.  Page 0 is the null page
    (``serving/kvpool.py``): idle-slot writes land there and masked reads
    never see it."""
    shape = (num_pages, page_size, plan.pad_heads, plan.head_dim)

    def shards():
        return [torch.zeros(shape, device=device, dtype=dtype)
                for _ in range(plan.num_devices)]

    return [{"k": shards(), "v": shards()} for _ in range(num_layers)]


def hmp_prefill(layers: Sequence, x, ring: LocalRing, pages: List[Dict], *,
                plan: ExecPlan, block_row, overlap: bool = False,
                seq: Optional[int] = None):
    """Run a stack of HMP layers over one prompt, writing its K/V into the
    paged pool.

    x: (1, S, d) — the bucket-padded prompt embeddings, in the plan's
    padded ragged layout of a ``seq``-row sequence when that is ragged.
    block_row: (pages_per_slot,) physical pages of this request.  K/V
    land at *absolute* positions [0, seq) of the request's pages (pad rows
    of a ragged layout never touch the pool); bucket-padding positions past
    the real prompt write zero-token K/V that decode overwrites before
    reading.  Pages are updated in place.  Returns (y, pages), y in x's
    layout.
    """
    if x.shape[0] != 1:
        raise ValueError("paged prefill is per-request: batch must be 1")
    layout = _resolve_layout(plan, ring, x, seq)
    s = x.shape[1] if layout is None else layout.seq
    page_size = pages[0]["k"][0].shape[1]
    block_row = torch.as_tensor(block_row, device=x.device).long()
    if s > block_row.shape[0] * page_size:
        raise ValueError(
            f"prompt of {s} positions exceeds the block row "
            f"({block_row.shape[0]} pages x {page_size})"
        )
    pos = torch.arange(s, device=x.device)
    phys = block_row[pos // page_size]
    within = pos % page_size
    rows = None if layout is None else torch.as_tensor(layout.rows, device=x.device)
    xs = _split_seq(x, ring.num_devices)
    for p, c in zip(layers, pages):
        xs, ks, vs = _hmp_layer_body(_as_shards(plan, p), xs, ring, plan=plan,
                                     overlap=overlap, layout=layout)
        for i in range(ring.num_devices):
            k, v = ks[i][0], vs[i][0]
            if rows is not None:
                k, v = k[rows], v[rows]
            c["k"][i][phys, within] = k
            c["v"][i][phys, within] = v
    return torch.cat(xs, dim=1), pages


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
    """(S, 1, d) -> q, k, v (S, 1, ph, hd) through the backend."""
    qkv = (compute.qkv_gemm(x, p["wqkv"]) if compute is not None
           else torch.matmul(x, p["wqkv"]))
    shape = (*x.shape[:2], ph, hd)
    return (t.reshape(shape) for t in qkv.split(ph * hd, dim=-1))


def _decode_layer(ps: List[Dict], x, pk: List[torch.Tensor],
                  pv: List[torch.Tensor], block_table, phys, within, valid, *,
                  plan: ExecPlan, ring: LocalRing):
    """Paged single-token TP step of one layer on every ring device.

    x: (S, 1, d) replicated slot batch.  Each device scatters its new K/V
    head shard into its page, gathers each slot's pages through the block
    table and attends under the per-slot length mask; the TP blocks exit
    through an all-reduce (a sum over the shards), and the connective
    blocks run once on the replicated result (the SP axis is degenerate at
    one token).  The projections go through the backend; the attention
    core is plain PyTorch."""
    computes = _make_compute(plan, None, None)
    ph, hd = plan.pad_heads, plan.head_dim
    s = block_table.shape[0]
    gs = []
    for i in range(ring.num_devices):
        comp = None if computes is None else computes[i]
        q, k_new, v_new = _decode_qkv(ps[i], x, comp, ph, hd)
        pk[i][phys, within] = k_new[:, 0]
        pv[i][phys, within] = v_new[:, 0]
        # read only this device's valid head slots of live pages; pad slots
        # route to the (zero) null page
        head_ok = torch.arange(ph, device=x.device) < plan.heads[i]
        ks = _paged_kv_gather(pk[i], block_table, head_ok)
        vs = _paged_kv_gather(pv[i], block_table, head_ok)
        scores = torch.einsum("bqhd,bthd->bhqt", q, ks).float() / math.sqrt(hd)
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full((), NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(vs.dtype)
        attn = torch.einsum("bhqt,bthd->bqhd", probs, vs).reshape(s, 1, ph * hd)
        gs.append(comp.wo_gemm(attn, ps[i]["wo"]) if comp is not None
                  else torch.matmul(attn, ps[i]["wo"]))
    p0 = ps[0]
    x = _ln(x + ring.psum(gs), p0["ln1_s"], p0["ln1_b"])
    fs = []
    for i in range(ring.num_devices):
        comp = None if computes is None else computes[i]
        if comp is not None:
            fs.append(comp.w2_gemm(_gelu(comp.w1_gemm(x, ps[i]["w1"])), ps[i]["w2"]))
        else:
            fs.append(torch.matmul(_gelu(torch.matmul(x, ps[i]["w1"])), ps[i]["w2"]))
    return _ln(x + ring.psum(fs), p0["ln2_s"], p0["ln2_b"])


def hmp_decode(layers: Sequence, x, ring: LocalRing, pages: List[Dict],
               positions, *, plan: ExecPlan, block_table):
    """One paged decode step of a continuous-batching slot batch.

    x: (S, 1, d) current-token embeddings; positions: (S,) absolute
    position each slot writes this step; block_table: (S, W) physical page
    per (slot, logical page).  Idle slots carry all-null block rows: their
    write lands in the null page and every null read is masked.  Pages are
    updated in place.  Returns (y, pages) with y (S, 1, d)."""
    if plan.num_devices != ring.num_devices:
        raise ValueError(
            f"plan covers {plan.num_devices} devices but the ring has "
            f"{ring.num_devices}"
        )
    block_table = torch.as_tensor(block_table, device=x.device).long()
    positions = torch.as_tensor(positions, device=x.device).long()
    page_size = pages[0]["k"][0].shape[1]
    s, w = block_table.shape
    phys = block_table[torch.arange(s, device=x.device), positions // page_size]
    within = positions % page_size
    valid = torch.arange(w * page_size, device=x.device)[None, :] <= positions[:, None]
    for p, c in zip(layers, pages):
        x = _decode_layer(_as_shards(plan, p), x, c["k"], c["v"], block_table,
                          phys, within, valid, plan=plan, ring=ring)
    return x, pages
