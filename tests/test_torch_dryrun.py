"""The dry run's counts (``roofline/counter.py``, ``launch/dryrun.py``)
against known answers, the paper's collective volumes, XLA's cost
analysis of the reference, and the HMP rules' numerics on two real ranks.

The per-chip counts are of the local ops each ``DTensor`` op runs, on
``torch.distributed``'s fake process group (nothing is allocated); a
fixture tears the group down after this file, so no other file in the
same worker sees it."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import reduced as j_reduced  # noqa: E402
from repro.launch.shapes import shape_config as j_shape_config  # noqa: E402
from repro.models.params import abstract_params as j_abstract_params  # noqa: E402
from repro.models.transformer import apply_model as j_apply_model  # noqa: E402
from repro.roofline.analysis import model_flops as j_model_flops  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.dryrun import count_step, run_one  # noqa: E402
from repro_torch.launch.shapes import SHAPES, shape_config  # noqa: E402
from repro_torch.models.params import padded_vocab  # noqa: E402
from repro_torch.models.sharding import abstract_tensor, axis_rules, make_rules  # noqa: E402
from repro_torch.roofline.analysis import model_flops  # noqa: E402
from repro_torch.roofline.counter import StepCounter, live_pairs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    mesh_lib.destroy_fake_group()


def _dt(shape, placements, mesh):
    """A fake fp32 ``DTensor`` of global ``shape`` with ``placements``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import contiguous_stride, local_shape_offset

    local = torch.empty(local_shape_offset(shape, mesh, placements)[0])
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


M, K, N = 256, 512, 1024
F32 = 4


def _count(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        mesh = mesh_lib.make_mesh((16, 16), ("data", "model"))
        counter = StepCounter()
        args = fn(mesh, None)
        with counter:
            fn(mesh, args)
    return counter


@pytest.mark.parametrize("pattern", ["rows", "contraction", "replicated"])
def test_matmul_counts_per_chip(pattern):
    """One (M x K) @ (K x N) fp32 matmul on 16 x 16: FLOPs are the global
    2MKN over the chips its output is split across (a partial sum counts as
    split), bytes are the local operands and result once, and no
    collective runs inside the product."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    R = Replicate()
    layouts = {  # x, w, expected output, chips the work is split over
        "rows": ([Shard(0), R], [R, Shard(1)], (Shard(0), Shard(1)), 256),
        "contraction": ([R, Shard(1)], [R, Shard(0)], (R, Partial()), 16),
        "replicated": ([R, R], [R, R], (R, R), 1),
    }
    xp, wp, outp, split = layouts[pattern]
    seen = {}

    def fn(mesh, args):
        if args is None:
            return _dt((M, K), xp, mesh), _dt((K, N), wp, mesh)
        seen["out"] = torch.mm(*args)

    c = _count(fn)
    out = seen["out"]
    assert tuple(out.placements) == outp
    assert c.flops == 2 * M * K * N / split
    x_local = M * K // {"rows": 16, "contraction": 16, "replicated": 1}[pattern]
    w_local = K * N // {"rows": 16, "contraction": 16, "replicated": 1}[pattern]
    assert c.bytes == F32 * (x_local + w_local + out.to_local().numel())
    assert c.collectives == {}


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter"])
def test_redistribution_counts_received_bytes(kind):
    """A redistribution counts its collective's output tensor on this chip
    (the reference's received-volume convention, each op weighted 1)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    R = Replicate()
    src, dst, want = {
        "all-gather": ([Shard(0), R], [R, R], M * N),
        "all-reduce": ([R, Partial()], [R, R], M * N),
        "reduce-scatter": ([R, Partial()], [R, Shard(0)], M * N // 16),
    }[kind]

    def fn(mesh, args):
        if args is None:
            return (_dt((M, N), src, mesh),)
        args[0].redistribute(mesh, dst)

    c = _count(fn)
    assert c.collectives == {kind: F32 * want}


def test_hmp_mlp_block_collectives_match_the_paper():
    """The HMP MLP block on a (1, 4) mesh (§III-B-4): entering from the
    seq-sharded connective block is one AllGather of the (B, S, d) input,
    leaving is one ReduceScatter of the (B, S, d) partial sums back to
    seq shards.  Counted as received volume, that is N and N / D bytes for
    N the input's bytes; the ring moves (D - 1) / D N bytes a device for
    either, which is what the port's cost model charges."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.layers import BSE
    from repro_torch.models.mlp import mlp_block

    cfg = reduced(get_config("qwen1.5-0.5b"))
    b, s, d, ff, dev = 2, 64, cfg.d_model, cfg.d_ff, 4
    with FakeTensorMode():
        rules = make_rules(mesh_lib.make_mesh((1, dev), ("data", "model")), "train",
                           batch_size=b)
        p = {"ln2": {"scale": abstract_tensor((d,), torch.float32, rules, (None,))},
             "mlp": {"w_gate": abstract_tensor((d, ff), torch.float32, rules,
                                               ("embed_w", "ffn_w")),
                     "w_up": abstract_tensor((d, ff), torch.float32, rules,
                                             ("embed_w", "ffn_w")),
                     "w_down": abstract_tensor((ff, d), torch.float32, rules,
                                               ("ffn_w", "embed_w"))}}
        x = abstract_tensor((b, s, d), torch.float32, rules, BSE)
        counter = StepCounter()
        with counter, axis_rules(rules):
            out = mlp_block(p, x, cfg)
    n_bytes = b * s * d * F32
    assert tuple(out.placements) == tuple(x.placements)
    assert counter.collectives == {"all-gather": n_bytes, "reduce-scatter": n_bytes / dev}
    link = costmodel.LinkSpec(bandwidth=1.0, latency=0.0)
    assert costmodel.t_allgather(counter.collectives["all-gather"], dev, link) == \
        pytest.approx((dev - 1) / dev * n_bytes)
    assert costmodel.t_reducescatter(counter.collectives["reduce-scatter"] * dev, dev, link) == \
        pytest.approx((dev - 1) / dev * n_bytes)


def test_live_pairs():
    assert live_pairs(4, 4, True, 0) == 10
    assert live_pairs(2, 6, True, 0) == 11          # queries right-aligned
    assert live_pairs(6, 6, True, 2) == 11
    assert live_pairs(3, 5, False, 0) == 15


def test_one_chip_count_against_xla_cost_analysis():
    """A 2-layer narrow qwen1.5-0.5b prefill (d 256, 4 heads, vocab 512,
    fp32) on a 1 x 1 mesh against XLA's ``cost_analysis()`` of the
    reference's step on one CPU device (layers unrolled).  The port counts
    matmul FLOPs and the causal half of the score matmuls, which equal the
    analytic count exactly; XLA also counts every elementwise op and the
    whole S x S score matmuls, ~1.5 % and ~1.2 % more here.  Tolerance:
    the port within 5 % below XLA, and never above it."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    jcfg = j_reduced(j_get_config("qwen1.5-0.5b"))
    b, s = 2, 64
    rules = make_rules(mesh_lib.make_mesh((1, 1), ("data", "model")), "prefill", batch_size=b)
    got = count_step(cfg, dict(seq=s, batch=b, mode="prefill"), rules)["counter"].flops

    d, h, hd, ff, v = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff, padded_vocab(cfg)
    per_layer = (2 * b * s * d * h * hd * 4 + 2 * b * s * d * ff * 3
                 + 4 * hd * h * b * live_pairs(s, s, True, 0))
    assert got == cfg.num_layers * per_layer + 2 * b * s * d * v

    def step(params, tokens):
        logits, _, _ = j_apply_model(params, jcfg, tokens=tokens, mode="prefill", unroll=True)
        return logits[:, -1]

    compiled = jax.jit(step).lower(j_abstract_params(jcfg),
                                   jax.ShapeDtypeStruct((b, s), jnp.int32)).compile()
    cost = compiled.cost_analysis()
    xla = float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])
    assert 0.95 * xla <= got <= xla


def test_model_flops_equal_reference():
    for arch in ASSIGNED_ARCHS:
        for shape, info in SHAPES.items():
            cfg = shape_config(get_config(arch), shape)
            jcfg = j_shape_config(j_get_config(arch), shape)
            train = info["mode"] == "train"
            assert model_flops(cfg, info, train) == j_model_flops(jcfg, info, train)


def test_run_one_record_on_one_chip():
    """``run_one`` on a 1 x 1 mesh: the reference's record keys, exact
    argument bytes (params and AdamW's fp32 moments), a bottleneck, and no
    collective."""
    rec = run_one("qwen1.5-0.5b", "train_small", save=False, verbose=False, mesh_shape=(1, 1),
                  shape_info=dict(seq=32, batch=2, mode="train"),
                  cfg_overrides=dict(num_layers=2))
    cfg = get_config("qwen1.5-0.5b")
    n = sum(t.numel() for t in _param_numels(cfg, 2))
    assert rec["argument_bytes"] == n * 2 + 2 * n * 4
    assert rec["collective_bytes_per_chip"] == {"total": 0.0}
    assert rec["bottleneck"] in ("compute", "memory")
    assert 0 < rec["useful_flops_ratio"] <= 1.05
    assert rec["peak_mem_bytes_per_chip"] >= rec["argument_bytes"] + rec["input_bytes"]


def _param_numels(cfg, layers):
    import dataclasses

    from repro_torch.models.params import _leaves

    c = dataclasses.replace(cfg, num_layers=layers)
    from repro_torch.models.params import abstract_params

    return [t for _, t in _leaves(abstract_params(c))]


_GLOO_WORKER = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

rank, port, cases = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import apply_model
from repro_torch.models.params import _leaves, _set, init_params, partition_specs
from repro_torch.models.sharding import axis_rules, make_rules
from repro_torch.serving import kvcache
from repro_torch.serving.kvcache import make_cache
from repro_torch.training.optimizer import AdamW, AdamWState, tree_leaves, tree_zeros
from repro_torch.training.train_loop import loss_fn, make_train_step

mesh = make_test_mesh(model=2, data=1)
b, s = 2, 16


def place(tree, spec_tree):
    specs, out = dict(_leaves(spec_tree)), {k: {} for k in tree}
    for path, leaf in _leaves(tree):
        _set(out, path, distribute_tensor(leaf, mesh, rules.placements(specs[path])))
    return out


def cache_specs(rules, cache):
    out = {}
    for path, leaf in _leaves(cache):
        axes = (None,) + tuple(kvcache._AXES[path[1].split("_", 1)[1]][path[-1]])
        _set(out, path, rules.spec(axes, shape=leaf.shape))
    return out


def clone(tree):
    out = {k: {} for k in tree}
    for path, leaf in _leaves(tree):
        _set(out, path, leaf.clone())
    return out


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def max_err(a, b):
    return max((full(x) - y).abs().max().item() for x, y in zip(a, b))


def grads(params, batch, rules):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with axis_rules(rules):
        loss, _ = loss_fn(params, batch, cfg, backend="eager")
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]


results = {}
for case in cases:
    cfg = dataclasses.replace(reduced(get_config(case["arch"])), **case["over"])
    params = init_params(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(3))
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=torch.Generator().manual_seed(2))
    ref_train, _ = apply_model(params, cfg, tokens=tokens, mode="train", backend="eager")
    cache = make_cache(cfg, b, s + 2)
    ref_pre, _ = apply_model(params, cfg, tokens=tokens, mode="prefill", cache=cache,
                             backend="eager")
    ref_dec, _ = apply_model(params, cfg, tokens=nxt, mode="decode", cache=cache, cache_index=s,
                             backend="eager")
    batch = {"tokens": tokens, "labels": labels}
    ref_loss, ref_grads = grads(params, batch, None)
    opt = AdamW(lambda step: 1e-3, eps=1e-3)
    ref_params = clone(params)
    make_train_step(cfg, opt, backend="eager")(ref_params, opt.init(ref_params), batch)
    adamw = AdamW(lambda step: 1e-3)
    ref_upd = clone(params)
    adamw.update([g.clone() for g in ref_grads], adamw.init(ref_upd), ref_upd)

    errs = {}
    with implicit_replication():
        rules = make_rules(mesh, "train", batch_size=b)
        specs = partition_specs(cfg, rules)
        dp = place(params, specs)
        with axis_rules(rules):
            out, _ = apply_model(dp, cfg, tokens=tokens, mode="train", backend="eager")
        errs["train"] = (out.full_tensor() - ref_train).abs().max().item()
        seq = rules.placements(rules.spec(("batch", "seq"), shape=(b, s)))
        dbatch = {k: distribute_tensor(v, mesh, seq) for k, v in batch.items()}
        loss, dgrads = grads(dp, dbatch, rules)
        errs["loss"] = abs(full(loss).item() - ref_loss.item())
        errs["grad"] = max_err(dgrads, ref_grads)

        def state():
            return AdamWState(torch.zeros((), dtype=torch.int32),
                              place(tree_zeros(params), specs), place(tree_zeros(params), specs))

        dp2 = place(clone(params), specs)  # (a replicated shard may share its storage)
        make_train_step(cfg, opt, rules, backend="eager")(dp2, state(), dbatch)
        errs["param"] = max_err(tree_leaves(dp2), tree_leaves(ref_params))
        errs["step"] = max_err(tree_leaves(dp2), tree_leaves(params))
        upd = place(clone(params), specs)
        dg = [distribute_tensor(g.clone(), mesh, p.placements)
              for g, p in zip(ref_grads, tree_leaves(upd))]
        with axis_rules(rules):
            adamw.update(dg, state(), upd)
        errs["update"] = max_err(tree_leaves(upd), tree_leaves(ref_upd))

        rules = make_rules(mesh, "prefill", batch_size=b)
        dcache = make_cache(cfg, b, s + 2)
        dcache = place(dcache, cache_specs(rules, dcache))
        with axis_rules(rules):
            out, dcache = apply_model(dp, cfg, tokens=tokens, mode="prefill", cache=dcache,
                                      backend="eager")
        errs["prefill"] = (out.full_tensor() - ref_pre).abs().max().item()
        rules = make_rules(mesh, "decode", batch_size=b)
        specs = dict(_leaves(cache_specs(rules, dcache)))
        dcache2 = {k: {} for k in dcache}
        for path, leaf in _leaves(dcache):
            _set(dcache2, path, leaf.redistribute(mesh, rules.placements(specs[path])))
        with axis_rules(rules):
            out, dcache2 = apply_model(dp, cfg, tokens=nxt, mode="decode", cache=dcache2,
                                       cache_index=s, backend="eager")
        errs["decode"] = (out.full_tensor() - ref_dec).abs().max().item()
        errs["cache"] = max((leaf.full_tensor() - dict(_leaves(cache))[path]).abs().max().item()
                            for path, leaf in _leaves(dcache2))
        errs["placements"] = {"/".join(path): str(leaf.placements)
                              for path, leaf in _leaves(dcache2)}
    errs["scale"] = ref_train.abs().max().item()
    errs["grad_scale"] = max(g.abs().max().item() for g in ref_grads)
    errs["param_scale"] = max(p.abs().max().item() for p in tree_leaves(ref_params))
    results[case["name"]] = errs
print(json.dumps(results))
dist.destroy_process_group()
"""

#: the reduced configs run on two gloo ranks: the head-sharded attention
#: (4 heads on the 2-way model axis), the SP-attention fallback (3 query
#: heads do not divide it: queries seq-sharded against gathered K/V, with
#: partial K/V gradients), MoE experts, the RG-LRU's log-depth scan with a
#: window shorter than the prompt (the rolling cache), and the xLSTM
GLOO_CASES = [
    {"name": "qwen1.5-0.5b", "arch": "qwen1.5-0.5b", "over": {}},
    {"name": "qwen-3-heads", "arch": "qwen1.5-0.5b", "over": {"num_heads": 3, "num_kv_heads": 1}},
    {"name": "granite-moe-3b-a800m", "arch": "granite-moe-3b-a800m", "over": {}},
    {"name": "recurrentgemma-9b", "arch": "recurrentgemma-9b", "over": {"window": 8}},
    {"name": "xlstm-350m", "arch": "xlstm-350m", "over": {}},
]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_results():
    """Every case of :data:`GLOO_CASES` run once on a (1, 2) mesh of two gloo
    ranks; {rank: {case: errors}}."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r), str(port),
                               json.dumps(GLOO_CASES)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def _check_forward(errs):
    tol = 1e-5 * max(1.0, errs["scale"])
    for what in ("train", "prefill", "decode", "cache"):
        assert errs[what] <= tol, (what, errs)


def test_forward_under_rules_on_two_gloo_ranks_equals_unsharded(gloo_results):
    """A reduced qwen1.5-0.5b (fp32, 4 heads) under the HMP rules on a
    (1, 2) mesh of two gloo ranks: the train-mode forward, a prefill into
    the cache and one decode step against the sequence-sharded cache give
    the unsharded logits and cache.  Tolerance 1e-5 of the largest logit:
    the same fp32 math, summed in another order where a contraction is
    split across the ranks."""
    for res in gloo_results:
        errs = res["qwen1.5-0.5b"]
        _check_forward(errs)
        assert "Shard(dim=2)" in errs["placements"]["groups/b0_attn/k"]


@pytest.mark.parametrize("case", [c["name"] for c in GLOO_CASES[1:]])
def test_other_layouts_on_two_gloo_ranks_equal_unsharded(gloo_results, case):
    """The forward, prefill and decode of the other reduced configs under
    the rules on two gloo ranks equal the unsharded ones, to the same
    1e-5 of the largest logit."""
    for res in gloo_results:
        _check_forward(res[case])


@pytest.mark.parametrize("case", [c["name"] for c in GLOO_CASES])
def test_train_step_on_two_gloo_ranks_equals_unsharded(gloo_results, case):
    """One train step under the rules on two gloo ranks: the loss and every
    parameter's gradient equal the unsharded step's within 1e-5 of the
    largest gradient, and the updated parameters within 1e-5 of the
    largest parameter (lr 1e-3, so the step itself is far larger than
    the tolerance).

    The whole step runs with AdamW's eps at 1e-3.  A first AdamW step maps
    a gradient g to about g / (|g| + eps), whose slope at g = 0 is 1 / eps:
    at the default 1e-8 a 1e-9 change in a near-zero gradient (a sum taken
    in another order) moves its parameter by 0.1 lr, which tests that
    slope, not the layout.  At 1e-3 a parameter moves by at most the
    gradient's change.  The sharded update at the default eps is held
    apart, on the unsharded step's own gradients ("update")."""
    for res in gloo_results:
        errs = res[case]
        assert errs["loss"] <= 1e-5, errs
        assert errs["grad"] <= 1e-5 * max(1.0, errs["grad_scale"]), errs
        assert errs["param"] <= 1e-5 * max(1.0, errs["param_scale"]), errs
        assert errs["update"] <= 1e-5 * max(1.0, errs["param_scale"]), errs
        assert errs["step"] >= 1e-4, errs


@pytest.mark.parametrize("s", [1, 7, 16])
def test_log_depth_scan_matches_the_scan_with_gradients(s):
    """The RG-LRU's log-depth scan (the mesh path, ``rglru._LogDepthScanFn``)
    against the plain scan under autograd: outputs and the gradients of
    a, b and h0 for weights on both outputs, within 1e-5 (fp32; the
    log-depth order multiplies the decays in another association)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.rglru import _LogDepthScanFn

    rng = np.random.default_rng(s)
    bsz, w = 2, 12
    a0 = torch.from_numpy(rng.uniform(0.5, 0.99, (bsz, s, w)).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal((bsz, s, w)).astype(np.float32))
    h00 = torch.from_numpy(rng.standard_normal((bsz, w)).astype(np.float32))
    wseq = torch.from_numpy(rng.standard_normal((bsz, s, w)).astype(np.float32))
    wlast = torch.from_numpy(rng.standard_normal((bsz, w)).astype(np.float32))

    def run(fn):
        a, b, h0 = (t.clone().requires_grad_() for t in (a0, b0, h00))
        h_seq, h_last = fn(a, b, h0)
        loss = (h_seq * wseq).sum() + (h_last * wlast).sum()
        return (h_seq.detach(), h_last.detach()) + torch.autograd.grad(loss, (a, b, h0))

    got = run(_LogDepthScanFn.apply)
    want = run(lambda a, b, h0: ops.rglru_scan(a, b, h0, backend="eager"))
    for g, r in zip(got, want):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)

