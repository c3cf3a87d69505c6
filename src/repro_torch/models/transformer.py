"""Model assembly: embeddings (token table, or the stubbed frontend's
embeddings) -> block groups -> tail blocks -> norm -> logits (one head,
or one per codebook).

The reference runs the groups as a ``jax.lax.scan`` over parameters
stacked along a leading group dim; here a Python loop walks the same
stacked tensors group by group (views from one ``torch.unbind`` per
leaf, no copies).  Remainder layers
(``num_layers % len(pattern)``) run after the groups as "tail" blocks.

Modes: "train" (no cache), "prefill" (fills the cache, or with a
``cache_index`` offset writes one chunk of it), "decode" (one token per
row).  Prefill and decode update the cache of
``serving/kvcache.py:make_cache`` in place and return it.

In train mode with ``cfg.remat`` each block group runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
group scan in ``jax.checkpoint``.  ``remat_policy="full"`` recomputes the
group's whole forward in the backward, so the flash and scan kernels
launch twice per layer and step.  ``"dots"`` is the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` through
selective checkpointing (:func:`dots_policy`): the outputs of products
with no batch dimension are saved, everything else is recomputed.
``"none"`` keeps every activation.

Dropout (``cfg.dropout_rate``, train steps given a ``generator`` and
``deterministic=False``, as the reference's ``rng``) drops each connective
block's sub-layer output with a mask drawn per (step seed, layer, site)
(``models/layers.py:DropoutStream``), layer ``g * len(pattern) + i`` as
the reference's ``jax.random.fold_in``: a recomputed group draws the same
masks again.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import cross_attention_block, self_attention_block
from repro_torch.models.layers import (DropoutStream, apply_norm, dropout_scope, products_batched,
                                       sinusoidal_pos)
from repro_torch.models.mlp import mlp_block
from repro_torch.models.moe import AUX_KEYS, moe_block
from repro_torch.models.params import group_slices, padded_vocab
from repro_torch.models.rglru import rglru_block
from repro_torch.models.sharding import (by_rows, constrain, from_local, local_shape_offset,
                                         rowwise, select_row)
from repro_torch.models.xlstm import mlstm_block, slstm_block


def _maybe_cast(tree, cfg: ModelConfig):
    """Weights stored in another ``param_dtype`` (fp8 for serving, fp32
    masters) are cast to the compute dtype one group at a time (transient,
    never resident), as jnp type promotion does at use in the reference."""
    target = getattr(torch, cfg.dtype)
    if cfg.param_dtype == cfg.dtype:
        return tree
    if isinstance(tree, dict):
        return {k: _maybe_cast(v, cfg) for k, v in tree.items()}
    return tree.to(target) if tree.is_floating_point() else tree


def embed_tokens(tok_w, tokens):
    """Rows of the token table.  Under a mesh the (vocab, embed)-sharded
    table is gathered whole once and each chip looks up its own tokens;
    where there are fewer tokens than vocab rows and the table is split
    along its vocab alone (the serving layouts), each chip looks the
    tokens up in its own vocab shard instead (:func:`_vocab_parallel`)."""
    tokens = constrain(tokens, ("batch", "seq")[:tokens.dim()])
    if _vocab_parallel(tok_w, 0, tokens.numel()):
        return _lookup_vocab_shard(tok_w, constrain(tokens, ("batch", None)[:tokens.dim()]))
    return by_rows(lambda rows, ws: ws[0][rows[0]], [tokens],
                   [constrain(tok_w, (None, None))])


def _vocab_parallel(w, vocab_dim: int, rows: int) -> bool:
    """Whether a lookup in, or a product with, the table ``w`` runs on each
    chip's vocab shard: ``w`` is a ``DTensor`` split along ``vocab_dim``
    alone, no gradient is taken (training gathers the table), and
    ``rows`` token rows are fewer than its vocab rows, so moving the rows'
    results costs less than gathering the table."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(w, DTensor) or (torch.is_grad_enabled() and w.requires_grad):
        return False
    splits = {p.dim for p in w.placements if isinstance(p, Shard)}
    return splits == {vocab_dim % w.dim()} and rows < w.shape[vocab_dim]


def _lookup_vocab_shard(tok_w, tokens):
    """Rows of the vocab-sharded table ``tok_w`` for ``tokens`` whole on the
    chips that split the vocab: each chip looks up the tokens of its own
    vocab range and gives zeros for the rest, so the rows are the chips'
    partial sums, exactly (one chip adds each row, the rest add zeros)."""
    from torch.distributed.tensor import Partial, Shard

    mesh = tok_w.device_mesh
    v0 = local_shape_offset(tok_w.shape, mesh, tok_w.placements)[1][0]
    wl, il = tok_w.to_local(), tokens.to_local() - v0
    inside = (il >= 0) & (il < wl.shape[0])
    rows = torch.where(inside[..., None], wl[il.clamp(0, wl.shape[0] - 1)],
                       torch.zeros((), dtype=wl.dtype, device=wl.device))
    placements = [Partial() if wp == Shard(0) else tp
                  for wp, tp in zip(tok_w.placements, tokens.placements)]
    return from_local(rows, mesh, placements, tuple(tokens.shape) + (tok_w.shape[1],))


def _logits_vocab_shard(x, w, fn, vocab_dim: int):
    """``fn(x, w)`` for a table ``w`` split along ``vocab_dim``: the rows of
    ``x`` whole on every chip, each chip's product with its vocab shard,
    the logits split along their last (vocab) dim."""
    from torch.distributed.tensor import Shard

    x = constrain(x, ("batch",) + (None,) * (x.dim() - 1))
    out = fn(x.to_local(), w.to_local())
    split = Shard(vocab_dim % w.dim())
    placements = [Shard(out.dim() - 1) if wp == split else xp
                  for wp, xp in zip(w.placements, x.placements)]
    return from_local(out, x.device_mesh, placements,
                      tuple(out.shape[:-1]) + (w.shape[vocab_dim],))


def compute_logits(params, cfg: ModelConfig, x):
    """x: (..., d) -> logits (..., V_padded) in the model dtype, or (...,
    cb, V_padded) for a model with ``num_codebooks > 1``; the pad vocab
    columns are -1e30.  Under a mesh the vocab-sharded table is gathered
    whole before the contraction (a weight AllGather, not a (B, S, V)
    AllReduce), or, for fewer rows than the vocab on a table split along
    its vocab alone, each chip multiplies by its own vocab shard and the
    logits are gathered (:func:`_vocab_parallel`)."""
    vp = padded_vocab(cfg)
    rows = x.numel() // x.shape[-1]
    if cfg.tie_embeddings:
        w, fn, vocab_dim = _maybe_cast(params["embed"]["tok"], cfg), lambda x, w: x @ w.T, 0
    else:
        w, vocab_dim = _maybe_cast(params["head"]["w"], cfg), 2

        def fn(x, w):
            return x @ w[0] if w.shape[0] == 1 else torch.einsum("...d,cdv->...cv", x, w)
    if _vocab_parallel(w, vocab_dim, rows):
        logits = _logits_vocab_shard(x, w, fn, vocab_dim)
    else:
        logits = rowwise(fn, x, constrain(w, (None,) * w.dim()))
    if vp != cfg.vocab_size:
        valid = torch.arange(vp, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.full((), -1e30, dtype=logits.dtype, device=x.device))
    # the sequence stays SP-sharded through the head; the vocab is whole
    axes = ("batch", "seq") if x.dim() == 3 else ("batch",)
    return constrain(logits, axes + (None,) * (logits.dim() - len(axes)))


def _apply_block(kind: str, p: Dict, x, cfg: ModelConfig, *, mode: str, cache,
                 positions, cache_index, backend: str, img_embeds):
    """One block and its FFN.  Returns (x, new_cache, aux): aux is the MoE
    FFN's aux dict, None for a dense FFN or a block without one."""
    if kind == "attn":
        x, new_cache = self_attention_block(
            p, x, cfg, mode=mode, window=cfg.window, cache=cache,
            positions=positions, cache_index=cache_index, backend=backend)
    elif kind == "xattn":
        x, new_cache = cross_attention_block(p, x, cfg, mode=mode, img_embeds=img_embeds,
                                             cache=cache)
    elif kind == "rec":
        x, new_cache = rglru_block(p, x, cfg, mode=mode, cache=cache, backend=backend)
    elif kind == "mlstm":
        x, new_cache = mlstm_block(p, x, cfg, mode=mode, cache=cache)
    elif kind == "slstm":
        x, new_cache = slstm_block(p, x, cfg, mode=mode, cache=cache)
    else:
        raise ValueError(kind)
    # FFN sub-layer of attention blocks (rec blocks keep Griffin's MLP; the
    # xLSTM blocks hold their projections inside)
    aux = None
    if kind in ("attn", "xattn", "rec"):
        if cfg.is_moe:
            x, aux = moe_block(p, x, cfg)
        elif cfg.d_ff > 0:
            x = mlp_block(p, x, cfg)
    return x, new_cache, aux


def _store(dst: Dict, src: Dict) -> None:
    """Write a block's new cache into its place in the model's cache
    (attention caches were already written in place)."""
    for name, t in src.items():
        if t is not dst[name]:
            dst[name].copy_(t)


#: products with no batch dimension: JAX's ``dot_general`` with empty
#: batch dimension numbers
_PLAIN_PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.mv,
                   torch.ops.aten.dot}
#: batched products, and the operand that carries the batch extent
_BATCHED_PRODUCTS = {torch.ops.aten.bmm: 0, torch.ops.aten.baddbmm: 1}


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The reference's ``dots_with_no_batch_dims_saveable`` on aten ops:
    save the output of a product with no batch dimension, recompute
    everything else.

    JAX keys on ``dot_general``'s batch dimensions; here ``mm``,
    ``addmm``, ``mv`` and ``dot`` have none.  ``torch.einsum`` lowers every
    contraction to ``bmm`` and folds the batch dims into its first one, so
    a ``bmm``/``baddbmm`` with batch extent 1 is a 2-D product in a view
    (``bsd,df->bsf``: saved) and one with a larger extent carries real
    batch dims (attention's QK^T and PV, the MoE expert einsums, per-head
    block-diagonal gates: recomputed).  Where batch dims may all have
    extent 1 (the MoE's token groups, one group for a short batch) the
    model code marks the product (``layers.batched_products``), and it is
    recomputed as JAX would.  The flash and scan kernels write through
    ``ctypes`` into ``empty`` outputs, which are recomputed, never cached:
    the recompute relaunches the kernel."""
    packet = op._overloadpacket
    if products_batched():
        return CheckpointPolicy.PREFER_RECOMPUTE
    if packet in _PLAIN_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    arg = _BATCHED_PRODUCTS.get(packet)
    if arg is not None and args[arg].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: the checkpoint contexts of the remat policies that recompute
_REMAT_CONTEXTS = {"full": noop_context_fn,
                   "dots": functools.partial(create_selective_checkpoint_contexts, dots_policy)}
#: remat policies the trainer takes
REMAT_POLICIES = ("full", "dots", "none")


def _check_train(cfg: ModelConfig) -> Optional[str]:
    """The remat policy a train step's groups run under (None: keep every
    activation); refuses a policy the port does not have."""
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise NotImplementedError(
            f"{cfg.name}: remat_policy {cfg.remat_policy!r}; one of {REMAT_POLICIES}")
    if not cfg.remat or cfg.remat_policy == "none":
        return None
    return cfg.remat_policy


def _input_device(params) -> torch.device:
    return params["final_norm"]["scale"].device


def apply_model(
    params,
    cfg: ModelConfig,
    *,
    tokens=None,
    embeds=None,
    img_embeds=None,
    mode: str = "train",
    cache: Optional[Dict] = None,
    cache_index=None,
    backend: str = "kernel",
    rows=None,
    aux: Optional[Dict] = None,
    generator: Union[torch.Generator, DropoutStream, None] = None,
    deterministic: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits, new_cache).

    tokens: (B, S) int token ids (``input_mode="token"``); embeds: (B, S,
    d) frontend embeddings (``input_mode="embed"``, the stubbed audio
    frontend); img_embeds: (B, num_image_tokens, d) for the ``xattn``
    blocks of a VLM, in train and prefill (decode reads the image K/V
    from the cache).  Inputs may be numpy arrays; they go to the params'
    device, and embeddings to the model dtype.

    cache_index: decode write position, a
    host int or a (B,) tensor of per-slot depths; in prefill, a host int
    offset, or a 0-dim tensor on the device (one process), selects chunked
    prefill at positions ``offset + arange(S)`` into the cache view
    (full-causal attention stacks only).  backend: "kernel" runs
    the flash and scan kernels (their plain versions on CPU tensors),
    "eager" the plain versions on any device.  rows: None for logits of
    every position, (B, S, V); else an int or a (B,) tensor naming one
    row per batch entry, for (B, V) logits of those rows only — the same
    numbers without the (B, S, V) buffer.  A codebook head adds a
    codebook dim before V.  aux: a dict that, when given,
    receives the MoE aux values summed over the layers (``moe_lb_loss``,
    ``moe_z_loss``, ``moe_drop_frac``; zeros for a model without experts).
    generator, deterministic: the reference's ``rng`` and
    ``deterministic``: with ``deterministic=False``, a generator and
    ``cfg.dropout_rate > 0`` each connective block drops its sub-layer's
    output.  The masks come from a :class:`~repro_torch.models.layers.
    DropoutStream` seeded with ``generator.initial_seed()`` (or the stream
    given), one generator per (layer, site).
    """
    if mode in ("prefill", "decode") and cache is None:
        raise ValueError(f"{mode} needs a cache from serving.kvcache.make_cache")
    if mode == "decode" and cache_index is None:
        raise ValueError("decode mode requires cache_index")
    chunked = mode == "prefill" and cache_index is not None
    if chunked and (cfg.window > 0 or any(k != "attn" for k in cfg.layer_kinds())):
        # checked before any block runs, so no cache is half written
        raise ValueError("chunked prefill requires full-causal attention")
    remat = _check_train(cfg) if mode == "train" else None
    stream = None
    if not deterministic and generator is not None and cfg.dropout_rate > 0:
        stream = (generator if isinstance(generator, DropoutStream)
                  else DropoutStream(generator.initial_seed()))
    dtype = getattr(torch, cfg.dtype)
    dev = _input_device(params)
    if cfg.input_mode == "token":
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.tensor(np.asarray(tokens), dtype=torch.long)
        tokens = tokens.to(dev).long()
        x = embed_tokens(_maybe_cast(params["embed"]["tok"], cfg), tokens).to(dtype)
    else:
        x = torch.as_tensor(embeds).to(device=dev, dtype=dtype)
    bsz, seq = x.shape[:2]
    if "xattn" in cfg.block_pattern + cfg.tail_pattern and mode != "decode":
        if img_embeds is None:
            raise ValueError(f"{cfg.name}: {mode} needs img_embeds for its xattn blocks")
        img_embeds = torch.as_tensor(img_embeds).to(device=dev, dtype=dtype)

    if mode == "decode":
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            positions = cache_index.to(dev)[:, None].expand(bsz, seq)
        else:
            positions = torch.full((bsz, seq), int(cache_index), device=dev)
    elif chunked:
        # a host int, or a 0-dim tensor on the device (read nothing on the host)
        off = cache_index.to(dev) if isinstance(cache_index, torch.Tensor) else int(cache_index)
        positions = (off + torch.arange(seq, device=dev)).expand(bsz, seq)
    else:
        positions = torch.arange(seq, device=dev).expand(bsz, seq)
    if isinstance(cache_index, torch.Tensor):
        cache_index = cache_index.to(dev)
    positions = constrain(positions, ("batch", None))
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model, dtype)
    x = constrain(x, ("batch", "seq", "embed"))

    kw = dict(mode=mode, positions=positions, cache_index=cache_index, backend=backend,
              img_embeds=img_embeds)

    per_group = len(cfg.block_pattern)

    def run(blocks, x, caches, first_layer):
        """Blocks [(kind, params, key)] in order, the first of them layer
        ``first_layer`` (its dropout masks' index); returns x and, for an
        MoE model, the aux values they add."""
        sums = ()
        for i, (kind, p, key) in enumerate(blocks):
            c = None if caches is None else caches[key]
            with dropout_scope(stream, first_layer + i, cfg.dropout_rate):
                x, c_new, a = _apply_block(kind, p, x, cfg, cache=c, **kw)
            if c_new is not None:
                _store(c, c_new)
            if a is not None:
                vals = tuple(a[name] for name in AUX_KEYS)
                sums = tuple(s + v for s, v in zip(sums, vals)) if sums else vals
        return (x,) + sums

    groups = group_slices(params, cfg.num_groups)

    def run_group(g, x):
        gparams = _maybe_cast(groups[g], cfg)
        caches = None if cache is None else {
            key: {n: t[g] for n, t in cache["groups"][key].items()}
            for key in cache["groups"]}
        return run([(kind, gparams[f"b{i}_{kind}"], f"b{i}_{kind}")
                    for i, kind in enumerate(cfg.block_pattern)], x, caches, g * per_group)

    sums = []  # each group's (and the tail's) MoE aux values
    for g in range(cfg.num_groups):
        if remat:
            out = checkpoint(run_group, g, x, use_reentrant=False, preserve_rng_state=False,
                             context_fn=_REMAT_CONTEXTS[remat])
        else:
            out = run_group(g, x)
        x, part = out[0], out[1:]
        sums.append(part)
    out = run([(kind, _maybe_cast(params["tail"][f"t{i}_{kind}"], cfg), f"t{i}_{kind}")
               for i, kind in enumerate(cfg.tail_pattern)], x,
              None if cache is None else cache["tail"], cfg.num_groups * per_group)
    x = out[0]
    sums.append(out[1:])
    if aux is not None:
        zero = torch.zeros((), device=dev)
        aux.update({name: sum((part[i] for part in sums if part), zero)
                    for i, name in enumerate(AUX_KEYS)})

    x = constrain(x, ("batch", "seq", "embed"))
    if rows is not None:
        if isinstance(rows, torch.Tensor):
            x = x[torch.arange(bsz, device=dev), rows.to(dev)]
        else:
            x = select_row(x, 1, int(rows))
    x = apply_norm(x, _maybe_cast(params["final_norm"], cfg), cfg.norm)
    logits = compute_logits(params, cfg, x)
    return logits, (None if mode == "train" else cache)
