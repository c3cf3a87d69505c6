"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory with exponential gating and a true sequential recurrence).

States are fp32 with max-stabilizer log-space gating (xLSTM eq. 15/24),
whatever the model dtype; a fresh state has ``m = -1e30`` (and, in the
sLSTM, ``n = 1e-6``), as ``serving/kvcache.py`` fills it.

The mLSTM prefill takes the chunkwise-parallel form when the length is a
multiple of ``cfg.mlstm_chunk`` and longer than one chunk, else the
recurrent step over every position, as the reference chooses;
``MLSTM_PATHS`` counts the prefills (and train passes) of each path.  The
reference runs the step path and the sLSTM as ``jax.lax.scan``; here they
are Python loops over the sequence in torch ops, as the reference has no
kernel for them.

Under a mesh (``models/sharding.py``): xlstm-350m has 4 heads, fewer
than the 16-way model axis, so TP shards the inner feature dims.  In the
mLSTM the state's value dim is model-sharded (the q-k contraction side
stays replicated), so the recurrence needs no sync; the sLSTM's step
mixes the whole per-head state, so its recurrent core is replicated and
TP re-enters at the row-parallel down projection.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import connective_norm, connective_residual
from repro_torch.models.sharding import by_rows, constrain, project, same_grad_layout

#: mLSTM prefill and train passes by path, since the last reset
MLSTM_PATHS = {"chunked": 0, "step": 0}


def reset_mlstm_paths() -> None:
    for k in MLSTM_PATHS:
        MLSTM_PATHS[k] = 0


def xlstm_dims(cfg: ModelConfig):
    """(inner width, heads, head width) of the xLSTM blocks."""
    di = int(cfg.d_model * cfg.proj_factor)
    nh = cfg.num_heads
    return di, nh, di // nh


def _mh_rmsnorm(h, scale):
    """Per-head RMS norm in fp32: h (..., nh, dh); scale (nh * dh,)."""
    hf = h.float()
    var = hf.square().mean(-1, keepdim=True)
    out = hf * torch.rsqrt(var + 1e-6)
    s = same_grad_layout((1.0 + scale.float()).reshape(h.shape[-2], h.shape[-1]))
    return (out * s).to(h.dtype)


# --- mLSTM -------------------------------------------------------------------

MLSTM_CACHE_AXES = {
    "c": ("batch", None, "inner", None),
    "n": ("batch", None, None),
    "m": ("batch", None),
}

def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    _, nh, dh = xlstm_dims(cfg)
    return {
        "c": torch.zeros((batch, nh, dh, dh), device=device),  # (v-dim, k-dim)
        "n": torch.zeros((batch, nh, dh), device=device),
        "m": torch.full((batch, nh), -1e30, device=device),
    }


def _mlstm_step(state, inp):
    """One recurrent step.  state: c (B, nh, dv, dk), n (B, nh, dk), m
    (B, nh); inp: q, k, v (B, nh, d*), i_raw, f_raw (B, nh)."""
    c, n, m = state
    q, k, v, i_raw, f_raw = inp
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(logf + m - m_new)
    c = f[..., None, None] * c + i[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f[..., None] * n + i[..., None] * k
    num = (c @ q[..., None])[..., 0]                       # bnvk,bnk->bnv
    den = torch.maximum((n * q).sum(-1).abs(), torch.exp(-m_new))
    return (c, n, m_new), num / den[..., None]


def mlstm_scan(q, k, v, i_raw, f_raw, state):
    """The recurrent step over every position.  q, k, v: (B, S, nh, d*)
    fp32; gates (B, S, nh).  Returns h (B, S, nh, dv) and the final
    state."""
    hs = []
    for t in range(q.shape[1]):
        state, h = _mlstm_step(state, (q[:, t], k[:, t], v[:, t], i_raw[:, t], f_raw[:, t]))
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_chunked(q, k, v, i_raw, f_raw, state, chunk: int):
    """Chunkwise-parallel mLSTM (exact, the recurrent step's stabilizer
    semantics): intra-chunk attention-like weights in log space, and the
    recurrence over chunk boundaries only."""
    b, s, nh, dk = k.shape
    assert s % chunk == 0
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    c_prev, n_prev, m_prev = state         # (B,nh,dv,dk), (B,nh,dk), (B,nh)
    hs = []
    for c0 in range(0, s, chunk):
        qt, kt, vt = q[:, c0:c0 + chunk], k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        it, ft = i_raw[:, c0:c0 + chunk], f_raw[:, c0:c0 + chunk]  # (B,L,nh)
        logf = F.logsigmoid(ft)
        bcum = torch.cumsum(logf, dim=1)   # inclusive decay sums
        # stabilizer: m_t = max(m_prev + b_t, max_{tau<=t}(b_t - b_tau + i_tau))
        gi = torch.cummax(it - bcum, dim=1).values
        m_t = torch.maximum(m_prev[:, None] + bcum, bcum + gi)    # (B,L,nh)
        # intra-chunk weights w[t,tau] = exp(b_t - b_tau + i_tau - m_t)
        logw = (bcum[:, :, None, :] - bcum[:, None, :, :] + it[:, None, :, :]
                - m_t[:, :, None, :])                           # (B, t, tau, nh)
        w = torch.where(tri[None, :, :, None], torch.exp(logw), 0.0)
        qk = torch.einsum("blnk,btnk->bltn", qt, kt)
        intra = torch.einsum("bltn,btnv->blnv", w * qk, vt)
        n_intra = torch.einsum("bltn,btnk->blnk", w, kt)
        # inter-chunk (state) term
        decay = torch.exp(m_prev[:, None] + bcum - m_t)         # (B,L,nh)
        inter = torch.einsum("blnk,bnvk->blnv", qt, c_prev) * decay[..., None]
        n_t = n_intra + n_prev[:, None] * decay[..., None]
        den = torch.maximum(torch.einsum("blnk,blnk->bln", n_t, qt).abs(), torch.exp(-m_t))
        hs.append((intra + inter) / den[..., None])
        # carry to the chunk end (position L-1)
        m_new = m_t[:, -1]
        c_decay = torch.exp(m_prev + bcum[:, -1] - m_new)
        wl = torch.exp(bcum[:, -1:, :] - bcum + it - m_new[:, None])  # (B,L,nh)
        c_prev = c_decay[..., None, None] * c_prev + torch.einsum(
            "btnv,btnk->bnvk", wl[..., None] * vt, kt)
        n_prev = c_decay[..., None] * n_prev + torch.einsum("btn,btnk->bnk", wl, kt)
        m_prev = m_new
    return torch.cat(hs, dim=1), (c_prev, n_prev, m_prev)


def mlstm_block(p: Dict, x, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """mLSTM sub-layer: norm -> up-projection -> per-head q/k/v and gates
    -> matrix-memory recurrence -> per-head norm, output gate ->
    down-projection -> residual.  Returns (x, new_cache); the cache is
    ``{"c", "n", "m"}`` in prefill and decode, None in train."""
    di, nh, dh = xlstm_dims(cfg)
    xn = connective_norm(x, p["ln"], cfg.norm)
    xg = constrain(xn, ("batch", None, "embed"))  # AllGather: enter the TP block
    b, s, _ = xg.shape
    up = constrain(xg @ p["w_up"], ("batch", None, "inner"))
    xi, og = up[..., :di], up[..., di:]
    # q and k contract over the whole head: the heads view needs xi whole
    xi_h = constrain(xi, ("batch", None, None)).reshape(b, s, nh, dh)
    # q and k on the contracted (replicated) side, v on the sharded value side
    q = torch.einsum("bsnd,nde->bsne", xi_h, p["wq"]).float()
    k = torch.einsum("bsnd,nde->bsne", xi_h, p["wk"]).float() / math.sqrt(dh)
    v = torch.einsum("bsnd,nde->bsne", xi_h, p["wv"]).float()
    q = constrain(q, ("batch", None, None, None))
    k = constrain(k, ("batch", None, None, None))
    v = constrain(v, ("batch", None, None, "inner"))
    gates = torch.einsum("bsnd,ndg->bsng", xi_h, p["w_if"]).float() + p["b_if"].float()
    i_raw, f_raw = gates[..., 0], gates[..., 1]

    state = cache if cache is not None else init_mlstm_cache(cfg, b, device=x.device)
    st = (state["c"], state["n"], state["m"])
    if mode == "decode":
        st, h = _mlstm_step(st, (q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0]))
        h = h[:, None]
    elif s % cfg.mlstm_chunk == 0 and s > cfg.mlstm_chunk:
        MLSTM_PATHS["chunked"] += 1
        h, st = mlstm_chunked(q, k, v, i_raw, f_raw, st, cfg.mlstm_chunk)
    else:
        MLSTM_PATHS["step"] += 1
        h, st = mlstm_scan(q, k, v, i_raw, f_raw, st)
    new_cache = None if mode == "train" else dict(zip(("c", "n", "m"), st))

    h = _mh_rmsnorm(h.to(x.dtype), p["mh_norm"]["scale"])
    h = constrain(h, ("batch", None, None, "inner"))
    # the inner dim is split inside each head: merging the heads needs it whole
    merged = same_grad_layout(constrain(h, ("batch", None, None, None)).reshape(b, -1, di))
    merged = merged * F.silu(og)
    return connective_residual(x, merged @ p["w_down"]), new_cache  # row-parallel


# --- sLSTM -------------------------------------------------------------------

SLSTM_CACHE_AXES = {k: ("batch", None, None) for k in ("h", "c", "n", "m")}

def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    _, nh, dh = xlstm_dims(cfg)
    z = torch.zeros((batch, nh, dh), device=device)
    return {"h": z, "c": z, "n": z + 1e-6, "m": torch.full_like(z, -1e30)}


def _slstm_step(state, x_part, w_rec):
    """x_part: (B, 4, nh, dh) fp32 pre-activations of the input
    projection; w_rec: (nh, dh, 4 * dh) fp32, the per-head recurrent
    matrix."""
    h, c, n, m = state
    b, _, nh, dh = x_part.shape
    rec = torch.bmm(h.transpose(0, 1), w_rec)                  # bnd,ndge->bgne
    raw = x_part + rec.view(nh, b, 4, dh).permute(1, 2, 0, 3)
    i_raw, f_raw, z_raw, o_raw = raw.unbind(1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(logf + m - m_new)
    c_new = f * c + i * torch.tanh(z_raw)
    n_new = f * n + i
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new), h_new


def _slstm_scan(x_part, w_rec, st):
    """The sLSTM step over every position: x_part (B, S, 4, nh, dh) fp32;
    returns h (B, S, nh, dh) and the final state."""
    hs = []
    for t in range(x_part.shape[1]):
        st, h = _slstm_step(st, x_part[:, t], w_rec)
        hs.append(h)
    return torch.stack(hs, dim=1), st


def slstm_block(p: Dict, x, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """sLSTM sub-layer: norm -> input projection -> the sequential
    scalar-memory recurrence -> per-head norm -> down-projection ->
    residual.  Returns (x, new_cache); the cache is ``{"h", "c", "n",
    "m"}`` in prefill and decode, None in train."""
    di, nh, dh = xlstm_dims(cfg)
    xn = connective_norm(x, p["ln"], cfg.norm)
    xn = constrain(xn, ("batch", None, "embed"))
    b, s, d = xn.shape
    x_part = project(xn, p["w_in"].reshape(d, -1), ("batch", None, None, None, None),
                     (b, s, 4, nh, dh))
    x_part = (x_part.view(b, s, 4, nh, dh) + p["b_in"]).float()
    w_rec = p["w_rec"].float().reshape(nh, dh, 4 * dh)

    state = cache if cache is not None else init_slstm_cache(cfg, b, device=x.device)
    st = tuple(constrain(state[k], SLSTM_CACHE_AXES[k]) for k in ("h", "c", "n", "m"))
    # each batch row's recurrence is its own: under a mesh each chip steps its rows
    h_seq, st = by_rows(lambda rows, ws: _slstm_scan(rows[0], ws[0], tuple(rows[1:])),
                        [x_part] + list(st), [w_rec])
    new_cache = None if mode == "train" else dict(zip(("h", "c", "n", "m"), st))

    h_seq = _mh_rmsnorm(h_seq.to(x.dtype), p["mh_norm"]["scale"])
    merged = constrain(h_seq.reshape(b, s, di), ("batch", None, "inner"))
    return connective_residual(x, merged @ p["w_down"]), new_cache  # row-parallel
