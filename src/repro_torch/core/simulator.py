"""Edge-cluster simulator: the paper's evaluation (Tables IV/V, Figs.
8-11) from the calibrated cost model and the planner, in numpy.

Schedules simulated:
  local           single device
  megatron (M-LM) TP, AllReduce x2/layer, connective redundant, equal split
  sp              sequence parallelism, weights replicated, 2 AllGathers/MHA
  galaxy          HMP + heterogeneity/memory-aware planning, sync collectives
  galaxy_overlap  galaxy + tile-based ring overlap (§III-D)

The ring-overlap saving per collective⊗GEMM pair is (D-1)·min(c, g) where c
is the per-hop transfer time and g the per-tile GEMM time: the schedule of
Figs. 6/7 (D GEMM tiles overlapping D-1 hops).

Ragged sequence parallelism: the galaxy schedules score a plan's uneven
sequence fractions (``Plan.seq``): the connective block runs at each
device's own tile, and each ring rotation step costs the slowest (held
tile, outgoing link) pair (``costmodel.t_ring_exchange``), over
per-device ``LinkSpec``s when ``link`` is a sequence.  The padded view of
the executor is scored by ``simulate_execplan(padded=True)``, where every
device holds (and ships) the straggler's tile.

Every figure here prices the edge cluster of ``costmodel``, not the GPU
the port runs on.  ``make_step_pricer`` is what ``obs.drift`` reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel, planner
from repro_torch.core.costmodel import DeviceSpec, LinkSpec
from repro_torch.core.execplan import ExecPlan
from repro_torch.core.profiler import AnalyticProfiler

OOM = float("inf")

# Tiling a GEMM into D ring stages lowers per-GEMM efficiency (smaller
# matrices; paper §IV-E observes this "potential underutilization ... due to
# matrix tiling").  ~5% per extra ring stage.
TILE_OVERHEAD = 0.05


@dataclasses.dataclass
class SimResult:
    latency: float                    # end-to-end seconds (inf = OOM)
    per_device_mem: Optional[np.ndarray] = None
    breakdown: Optional[Dict[str, float]] = None

    @property
    def oom(self) -> bool:
        return not np.isfinite(self.latency)


def _embed_bytes(cfg: ModelConfig) -> float:
    return cfg.vocab_size * cfg.d_model * costmodel.BYTES_FP16


def _overlap_layer_time(compute_total: float, comm_total: float, d: int) -> float:
    """Global overlap model for one layer: the D-1 ring hops of all four
    collective⊗GEMM pairs (§III-D) overlap with whatever compute the layer
    has in flight (tile GEMMs, attention core, connective); only the excess
    communication is exposed.  Tiled GEMMs pay a small efficiency penalty."""
    compute_total = compute_total * (1.0 + TILE_OVERHEAD * (d - 1))
    exposed = max(0.0, comm_total - compute_total)
    return compute_total + exposed


def simulate(
    cfg: ModelConfig,
    devices: Sequence[DeviceSpec],
    link: costmodel.Links,
    seq: int,
    schedule: str,
    plan: Optional[planner.Plan] = None,
    context_len: Optional[int] = None,
) -> SimResult:
    """Score one schedule on a simulated edge cluster.

    ``link`` is one LinkSpec for a uniform interconnect or one per device
    (ring order, outgoing).  Non-galaxy schedules move whole tensors every
    step, so heterogeneous links reduce to the bottleneck hop for them.

    ``plan`` (galaxy schedules only) scores an externally supplied partition
    — e.g. one re-expressed from an ``ExecPlan`` — instead of re-running the
    planner, so the simulator and the real executor consume the *same* plan.

    ``context_len`` (galaxy schedules only) prices a *suffix-only* prefill
    after a shared-prefix KV-cache hit: ``seq`` is the uncached suffix the
    layer GEMMs/transport/connective actually run over, while the attention
    core reads keys for the full ``context_len`` positions (the cached
    prefix is gathered from shared pages, not recomputed) — its
    :math:`S'^2` self-attention term rescales to :math:`S' \\cdot K`.
    """
    if plan is not None and schedule not in ("galaxy", "galaxy_overlap"):
        raise ValueError(f"plan= only applies to galaxy schedules, not {schedule!r}")
    if context_len is not None:
        if schedule not in ("galaxy", "galaxy_overlap"):
            raise ValueError(
                f"context_len= only applies to galaxy schedules, not {schedule!r}"
            )
        if context_len < seq:
            raise ValueError(
                f"context_len {context_len} must cover the suffix of {seq} rows"
            )
    d_n = len(devices)
    links = costmodel.as_ring_links(link, d_n)
    link = costmodel.bottleneck_link(links, d_n)
    prof = AnalyticProfiler(cfg, seq)
    p = prof.prof
    l = cfg.num_layers
    act = p["act_bytes"]
    flops = np.array([dev.flops for dev in devices])
    bws = np.array([dev.mem_bw for dev in devices])
    budgets = np.array([dev.memory_budget for dev in devices])

    if schedule == "local":
        dev = devices[0]
        mem = costmodel.model_memory_bytes(cfg)
        if mem > dev.memory_budget:
            return SimResult(OOM, np.array([mem]))
        t = l * (
            (p["mha_flops"] + p["mlp_flops"]) / dev.flops
            + p["con_bytes"] / dev.mem_bw
        )
        return SimResult(t, np.array([mem]))

    if schedule == "megatron":
        # Megatron shards the embedding vocab-parallel as well
        mem = l * (p["m_att"] + p["m_mlp"]) / d_n + _embed_bytes(cfg) / d_n
        per_dev = np.full(d_n, mem)
        if np.any(per_dev > budgets):
            return SimResult(OOM, per_dev)
        t_mha = np.max(p["mha_flops"] / d_n / flops)
        t_mlp = np.max(p["mlp_flops"] / d_n / flops)
        t_con = np.max(p["con_bytes"] / bws)  # redundant on every device
        t_comm = 2 * costmodel.t_allreduce(act, d_n, link)
        t = l * (t_mha + t_mlp + t_con + t_comm)
        return SimResult(t, per_dev, {"comm": l * t_comm, "con": l * t_con})

    if schedule == "sp":
        mem = costmodel.model_memory_bytes(cfg)
        per_dev = np.full(d_n, mem)
        if np.any(per_dev > budgets):
            return SimResult(OOM, per_dev)
        t_comp = np.max((p["mha_flops"] + p["mlp_flops"]) / d_n / flops)
        t_con = np.max(p["con_bytes"] / d_n / bws)
        t_comm = 2 * costmodel.t_allgather(act, d_n, link)  # gather K and V
        t = l * (t_comp + t_con + t_comm)
        return SimResult(t, per_dev, {"comm": l * t_comm, "con": l * t_con})

    if schedule in ("galaxy", "galaxy_overlap"):
        dev_profiles = prof.device_profiles(devices)
        model_profile = prof.model_profile()
        pl = plan if plan is not None else planner.plan(model_profile, dev_profiles)
        if len(pl.mha) != d_n:
            raise ValueError(
                f"plan covers {len(pl.mha)} devices, cluster has {d_n}"
            )

        # fractions vs the *model's* totals, not the plan's sum: identical for
        # planner output (counts sum to the totals) but also correct for
        # padded ExecPlans, where every device executes max(units).
        a_frac = pl.mha / model_profile.num_heads
        b_frac = pl.mlp / model_profile.mlp_columns
        seq_frac = np.asarray(pl.seq, dtype=float)
        per_dev = (
            model_profile.num_layers
            * (model_profile.m_att * a_frac + model_profile.m_mlp * b_frac)
            + _embed_bytes(cfg) / d_n
        )
        if not pl.feasible or np.any(per_dev > budgets):
            return SimResult(OOM, per_dev)
        # split MHA compute: QKV+WO GEMMs (overlappable) vs attention core
        hd, h, kv, dm = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
        qkv_flops = 2 * seq * dm * (h * hd + 2 * kv * hd)
        wo_flops = 2 * seq * (h * hd) * dm
        attn_core = p["mha_flops"] - qkv_flops - wo_flops
        gate = 3 if cfg.activation in ("swiglu", "geglu") else 2
        mlp1_flops = (gate - 1) * 2 * seq * dm * cfg.d_ff
        mlp2_flops = 2 * seq * dm * cfg.d_ff

        if context_len is not None and seq > 0:
            # suffix queries attend over the full context: the S'^2 core
            # becomes S' * K (scores + weighted sum are linear in keys)
            attn_core = attn_core * (context_len / seq)
        t_attn_core = np.max(a_frac * attn_core / flops)
        # connective blocks run at each device's own (possibly uneven)
        # sequence tile, memory-bandwidth-bound
        t_con = np.max(seq_frac * p["con_bytes"] / bws)

        # each ring rotation moves the per-device sequence tiles; a step is
        # gated by the slowest (held tile, outgoing link) pair.  For equal
        # tiles on a uniform link this equals the old closed forms.  Bucketed
        # ragged transport ships bucket-rounded rows (Plan.seq_wire) instead
        # of whatever the compute view holds — compute/connective terms above
        # stay on ``seq``, only the wire is repriced.
        wire_frac = seq_frac if getattr(pl, "seq_wire", None) is None \
            else np.asarray(pl.seq_wire, dtype=float)
        tile_bytes = wire_frac * act
        t_rotation = costmodel.t_ring_exchange(tile_bytes, links)
        pairs = [
            (qkv_flops, a_frac),   # AllGather ⊗ QKV GEMM
            (wo_flops, a_frac),    # WO GEMM ⊗ ReduceScatter
            (mlp1_flops, b_frac),  # AllGather ⊗ GEMM1
            (mlp2_flops, b_frac),  # GEMM2 ⊗ ReduceScatter
        ]
        t_gemms = sum(np.max(fl * fr / flops) for fl, fr in pairs)
        if schedule == "galaxy":
            t_comm = 4 * t_rotation  # 2 AllGathers + 2 ReduceScatters
            t_layer = t_attn_core + t_gemms + t_con + t_comm
        else:
            comm_total = 4 * t_rotation  # hops of all 4 ring pairs
            t_layer = _overlap_layer_time(
                t_attn_core + t_gemms + t_con, comm_total, d_n
            )
        return SimResult(
            l * t_layer,
            per_dev,
            {"con": l * t_con, "attn_core": l * t_attn_core},
        )

    raise ValueError(schedule)


def simulate_execplan(
    eplan: ExecPlan,
    cfg: ModelConfig,
    devices: Sequence[DeviceSpec],
    link: costmodel.Links,
    seq: int,
    *,
    overlap: bool = True,
    padded: bool = False,
    cached_prefix: int = 0,
) -> SimResult:
    """Score the exact plan the executor runs (``core/execplan.ExecPlan``).

    ``cached_prefix`` prices a shared-prefix KV-cache hit
    (``serving/prefix_cache.py``): prefill runs only over the
    ``seq - cached_prefix`` uncached suffix rows (GEMMs, ring transport and
    connective all shrink with the suffix), while the attention core still
    reads the full ``seq`` keys from the shared pages.

    ``padded=False`` scores the planner's assigned workload (paper Eq. 4/5);
    ``padded=True`` scores the padded execution view, which depends on the
    plan's ``compute_backend``: under "eager" every device runs
    ``max(units)`` dense units and ships the straggler's ``max(fraction)``
    sequence tile; under "kernel" the valid-length kernels skip pad
    blocks, so the compute axes score the assigned units (``padded=True``
    then differs from ``padded=False`` only in the padded-tile
    transport/connective terms; block-rounding residue is ignored).
    """
    if eplan.num_devices != len(devices):
        raise ValueError(
            f"plan covers {eplan.num_devices} devices, cluster has {len(devices)}"
        )
    schedule = "galaxy_overlap" if overlap else "galaxy"
    if cached_prefix:
        if not 0 <= cached_prefix < seq:
            raise ValueError(
                f"cached_prefix {cached_prefix} must lie in [0, seq={seq})"
            )
        return simulate(cfg, devices, link, seq - cached_prefix, schedule,
                        plan=eplan.to_planner_plan(padded=padded),
                        context_len=seq)
    return simulate(cfg, devices, link, seq, schedule,
                    plan=eplan.to_planner_plan(padded=padded))


def spec_decode_summary(
    eplan: ExecPlan,
    cfg: ModelConfig,
    devices: Sequence[DeviceSpec],
    link: costmodel.Links,
    *,
    draft_cfg: ModelConfig,
    k: int,
    acceptance: float,
    context_len: int,
) -> Dict[str, float]:
    """Price one speculative round against plain decode on the same plan
    (``serving/spec.py``): the draft model runs ``k`` sequential steps alone
    on the fastest device, then the whole mesh verifies all drafts in one
    ``k+1``-row chunk prefill over the paged cache.

    Every mesh-side step is a suffix-only prefill of the live context:
    plain decode is the 1-row case (``cached_prefix = context - 1``) and
    the verify chunk the ``k+1``-row case — same pricing machinery, so the
    comparison isolates exactly what speculation changes (amortizing the
    per-step transport/connective over ``E`` emitted tokens).  ``speedup``
    is ``E * t_decode / (k * t_draft + t_verify)`` with ``E`` from
    ``costmodel.spec_expected_tokens``; the planner picks ``k`` by maximizing
    it (``choose_spec_k``).
    """
    if context_len <= k + 1:
        raise ValueError(
            f"context_len {context_len} must exceed the k+1={k + 1} verify rows"
        )
    e_tok = costmodel.spec_expected_tokens(acceptance, k)
    t_decode = simulate_execplan(
        eplan, cfg, devices, link, context_len,
        cached_prefix=context_len - 1,
    ).latency
    t_verify = simulate_execplan(
        eplan, cfg, devices, link, context_len,
        cached_prefix=context_len - (k + 1),
    ).latency
    fastest = max(range(len(devices)), key=lambda i: devices[i].flops)
    # the draft runs alone on the fastest device ("local": no transport),
    # so a heterogeneous ring collapses to any single link
    t_draft = simulate(
        draft_cfg, [devices[fastest]],
        costmodel.bottleneck_link(link, len(devices)), 1, "local",
    ).latency
    t_round = k * t_draft + t_verify
    return {
        "k": float(k),
        "acceptance": float(acceptance),
        "expected_tokens": e_tok,
        "t_decode": t_decode,
        "t_draft": t_draft,
        "t_verify": t_verify,
        "time_per_token_plain": t_decode,
        "time_per_token_spec": t_round / e_tok,
        "speedup": e_tok * t_decode / t_round,
    }


def make_step_pricer(
    eplan: ExecPlan,
    cfg: ModelConfig,
    devices: Sequence[DeviceSpec],
    link: costmodel.Links,
    *,
    draft_cfg: Optional[ModelConfig] = None,
    overlap: bool = True,
):
    """Memoized per-step pricer for the serving drift monitor
    (``obs.drift.DriftMonitor``).

    Every serving step the engine executes is priced as the suffix-only
    prefill ``spec_decode_summary`` already uses: a step of ``rows`` new
    positions at live context ``context`` is
    ``simulate_execplan(..., seq=context, cached_prefix=context - rows)`` —
    decode is the 1-row case, a chunked-prefill step the chunk-size-row
    case, a speculative verify chunk the ``k+1``-row case.  The ``kind``
    string only routes ``"draft"`` steps (priced on the fastest device
    alone, needs ``draft_cfg``); all mesh-side kinds share the same math
    and exist so the monitor can histogram them separately.

    Returns ``price(kind, rows=, context=) -> Optional[seconds]`` —
    ``None`` for unpriceable steps (degenerate geometry, unknown draft), so
    the monitor skips them instead of recording garbage.  Results are
    memoized per ``(kind, rows, context)``: serving revisits a small set of
    step shapes thousands of times, and the analytic model is pure.
    """
    if eplan.num_devices != len(devices):
        raise ValueError(
            f"plan covers {eplan.num_devices} devices, cluster has {len(devices)}"
        )
    cache: Dict[tuple, Optional[float]] = {}
    fastest = max(range(len(devices)), key=lambda i: devices[i].flops)

    def price(kind: str, *, rows: int = 1, context: int = 0) -> Optional[float]:
        rows = int(rows)
        context = int(context)
        if rows < 1 or context < rows:
            return None
        key = (kind, rows, context)
        if key not in cache:
            if kind == "draft":
                if draft_cfg is None:
                    cache[key] = None
                else:
                    cache[key] = rows * simulate(
                        draft_cfg, [devices[fastest]],
                        costmodel.bottleneck_link(link, len(devices)),
                        1, "local",
                    ).latency
            else:
                cache[key] = simulate_execplan(
                    eplan, cfg, devices, link, context,
                    overlap=overlap, cached_prefix=context - rows,
                ).latency
        return cache[key]

    return price


def choose_spec_k(
    eplan: ExecPlan,
    cfg: ModelConfig,
    devices: Sequence[DeviceSpec],
    link: costmodel.Links,
    *,
    draft_cfg: ModelConfig,
    acceptance: float,
    context_len: int,
    k_max: int = 8,
) -> Dict[str, float]:
    """Sweep draft depth and return the ``spec_decode_summary`` of the best
    ``k`` (highest modeled speedup; k=1..k_max, bounded by the context).
    Deeper drafts amortize more mesh steps but each extra position lands
    with probability ``acceptance^j``, so the curve peaks and then decays —
    the returned summary is the planner's pick for ``--spec-k``."""
    best: Optional[Dict[str, float]] = None
    for k in range(1, k_max + 1):
        if context_len <= k + 1:
            break
        s = spec_decode_summary(
            eplan, cfg, devices, link, draft_cfg=draft_cfg,
            k=k, acceptance=acceptance, context_len=context_len,
        )
        if best is None or s["speedup"] > best["speedup"]:
            best = s
    if best is None:
        raise ValueError(
            f"context_len {context_len} leaves no room for any draft depth"
        )
    return best


def speedup_table(
    cfg: ModelConfig,
    devices: Sequence[DeviceSpec],
    link: LinkSpec,
    seq: int,
    baselines: Sequence[str] = ("megatron", "sp"),
    galaxy: str = "galaxy_overlap",
) -> Dict[str, object]:
    g = simulate(cfg, devices, link, seq, galaxy)
    out: Dict[str, object] = {"galaxy_s": g.latency}
    for b in baselines:
        r = simulate(cfg, devices, link, seq, b)
        if g.oom:
            out[b] = "GALAXY-OOM"
        elif r.oom:
            out[b] = "OOM"
        else:
            out[b] = r.latency / g.latency
    return out


def weak_scaling(cfg: ModelConfig, device: DeviceSpec, link: LinkSpec,
                 seq_per_device: int, max_devices: int = 4) -> List[float]:
    """Fig. 10: FLOPS scaling efficiency vs linear, single layer."""
    import dataclasses as dc

    cfg1 = dc.replace(cfg, num_layers=1)
    effs = []
    base = None
    for d_n in range(1, max_devices + 1):
        seq = seq_per_device * d_n
        devices = [device] * d_n
        sched = "galaxy_overlap" if d_n > 1 else "local"
        r = simulate(cfg1, devices, link, seq, sched)
        p = costmodel.layer_profile(cfg1, seq)
        flops_rate = (p["mha_flops"] + p["mlp_flops"]) / r.latency
        if base is None:
            base = flops_rate
        effs.append(flops_rate / (base * d_n))
    return effs


def strong_scaling(cfg: ModelConfig, device: DeviceSpec, link: LinkSpec,
                   seq: int, max_devices: int = 4) -> List[float]:
    """Fig. 11: per-layer latency speedup vs local inference."""
    import dataclasses as dc

    cfg1 = dc.replace(cfg, num_layers=1)
    base = simulate(cfg1, [device], link, seq, "local").latency
    out = []
    for d_n in range(1, max_devices + 1):
        sched = "galaxy_overlap" if d_n > 1 else "local"
        r = simulate(cfg1, [device] * d_n, link, seq, sched)
        out.append(base / r.latency)
    return out
