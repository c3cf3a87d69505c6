"""One of the two gloo ranks of ``tests/test_torch_zoo_ranks.py``.

  python tests/torch_zoo_ranks_worker.py RANK PORT DIR

Reads ``DIR/inputs.json`` (the cases, the batch, the decode tokens, the
serve's prompts) and ``DIR/<case>.npz`` (the reference's weights, flat by
"/"-joined path) and writes ``DIR/rank<RANK>.npz`` (logits) and
``DIR/rank<RANK>.json`` (everything else).  The mesh is (data 1, model 2)
under ``make_rules(mesh, "prefill")``; the port runs on the CPU, where the
kernel wrappers run their plain versions, so the wrappers' calls
(``kernels/ops.call_log``) and the eager mesh scan's show which path a
backend took.  Last, the staged collectives of ``core/ring.py`` on CPU
tensors.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def unflatten(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = arr
    return tree


def counted(mod, attr, calls):
    """Wrap ``mod.attr`` so each call appends its first argument's shape to
    ``calls``."""
    fn = getattr(mod, attr)

    def wrapper(x, *args, **kw):
        calls.append(list(x.shape))
        return fn(x, *args, **kw)

    setattr(mod, attr, wrapper)


def take(log_depth):
    """The calls since the last take: each kernel wrapper's, by signature
    with their number (``kernels/ops.call_log``), and the eager mesh scan's
    shapes."""
    from repro_torch.kernels import ops

    out = {**ops.call_log(), "log_depth_scan": list(log_depth)}
    ops.reset_call_log()
    log_depth.clear()
    return out


def staged_collectives(group_name):
    """Each of ``core/ring.MESH_COLLECTIVES`` through its staged kernel on
    this rank's CPU tensors over the gloo group ``group_name``: whether it
    gives what the collective gives unstaged, and the calls counted; then
    once over a group of another backend ("fake"), which must run torch's
    own kernel and count nothing."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"

    from repro_torch.core.ring import MESH_COLLECTIVES, MESH_STAGED, _staged_collective

    x = torch.arange(8, dtype=torch.float32) + 100 * dist.get_rank()
    args = {"all_gather_into_tensor": (2,), "reduce_scatter_tensor": ("sum", 2),
            "all_reduce": ("sum",), "all_to_all_single": ([4, 4], [4, 4]),
            "broadcast": (0,), "shard_dim_alltoall": (0, 0)}
    wait = torch.ops._c10d_functional.wait_tensor
    equal = {}
    for ns, name in MESH_COLLECTIVES:
        op = getattr(getattr(torch.ops, ns), name)
        got = wait(_staged_collective(ns, name)(x, *args[name], group_name))
        equal[name] = torch.equal(got, wait(op(x, *args[name], group_name)))
    counts = {k: list(v) for k, v in MESH_STAGED.items()}
    fake = dist.new_group([0, 1], backend="fake")
    wait(_staged_collective("_c10d_functional", "all_reduce")(x, "sum", fake.group_name))
    return {"equal": equal, "counts": counts,
            "fake_counted": MESH_STAGED["all_reduce"][0] - counts["all_reduce"][0]}


def paged_calls(ex, pg):
    """The paged protocol's calls on ``ex``, as the engine makes them: a
    bucket-padded prompt ``a`` prefilled in one shot into row 0, and in
    page-aligned chunks into row 1, then a chunk at an unaligned offset
    there (where a verify chunk goes); ``b``'s suffix into row 2 over row
    0's shared pages (a prefix hit); then decode steps of the three rows at
    their own depths beside an idle slot on the null page.  Returns each
    call's logits and the pool."""
    page, width, shared, chunk = pg["page"], pg["width"], pg["shared"], pg["chunk"]
    len_a, len_b = pg["len_a"], pg["len_b"]
    a, b, verify = np.array([pg["a"]]), np.array([pg["b"]]), np.array([pg["verify"]])
    pool = ex.make_pool(1 + 3 * width, page)
    rows = [list(range(1 + i * width, 1 + (i + 1) * width)) for i in range(3)]
    rows[2][:shared // page] = rows[0][:shared // page]
    outs = []
    out, pool = ex.prefill_paged(a, pool, rows[0], length=len_a)
    outs.append(out)
    for off in range(0, a.shape[1], chunk):
        out, pool = ex.prefill_chunk(a[:, off:off + chunk], pool, rows[1], offset=off,
                                     length=len_a)
        outs.append(out)
    out, pool = ex.prefill_chunk(verify, pool, rows[1], offset=len_a,
                                 length=len_a + verify.shape[1])
    outs.append(out)
    out, pool = ex.prefill_chunk(b[:, shared:], pool, rows[2], offset=shared, length=len_b)
    outs.append(out)
    table = np.array(rows + [[0] * width])
    pos = np.array([len_a, len_a + verify.shape[1], len_b, 0])
    for step in pg["steps"]:
        out, pool = ex.decode_paged(np.array(step)[:, None], pool, table, pos)
        outs.append(out)
        pos = pos + (pos > 0)
    return [o.detach().numpy() for o in outs], pool


def whole_leaves(pool):
    """{"part/key/name": the leaf, whole} of a cache tree."""
    return {f"{part}/{key}/{n}": (leaf.full_tensor() if hasattr(leaf, "full_tensor")
                                  else leaf).detach().numpy()
            for part, blocks in pool.items() for key, leaves in blocks.items()
            for n, leaf in leaves.items()}


def paged_comms(ex, pg):
    """The collectives (``CommDebugMode``) of a page gather, a page scatter
    and a ``decode_paged`` step of four slots at their own depths, and of a
    lockstep ``decode`` step of the same batch."""
    from torch.distributed.tensor.debug import CommDebugMode

    page, width = pg["page"], pg["width"]
    pool = ex.make_pool(1 + 4 * width, page)
    bt = torch.arange(1, 1 + 4 * width).view(4, width)
    pos = torch.tensor([5, 9, 3, 12])
    rows = torch.arange(4)
    tokens = np.array(pg["steps"][0])[:, None]
    cache = ex.make_cache(4, width * page)
    dense = ex.gather_pages(pool, bt)
    calls = {"gather": lambda: ex.gather_pages(pool, bt),
             "scatter": lambda: ex._scatter(pool, dense, bt[rows, pos // page], pos % page,
                                            rows, pos),
             "decode_paged": lambda: ex.decode_paged(tokens, pool, bt, pos),
             "decode": lambda: ex.decode(tokens, cache, 12)}
    out = {}
    for what, fn in calls.items():
        with CommDebugMode() as comm:
            fn()
        out[what] = {str(op): n for op, n in comm.get_comm_counts().items()}
    return out


def describe(got):
    """What a paged call under the mesh gave: the logits' shape and whether
    they are finite, a pool's first leaf (shape, placements, local shape),
    or an engine's scheduler."""
    if isinstance(got, tuple):
        logits, pool = got
        return {"shape": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
                "pool": describe(pool)}
    if isinstance(got, dict):
        leaf = got["groups"]["b0_attn"]["k"]
        return {"shape": list(leaf.shape), "placements": [str(p) for p in leaf.placements],
                "local": list(leaf.to_local().shape)}
    return {"scheduler": got.scheduler, "supports_paged": got.executor.supports_paged}


def serve_all(spec, executors, draft, rank):
    """The engine on the mesh (every serve of ``spec["serves"]``) and, on
    rank 0, on one process (those marked "one"): tokens, stats, whether the
    pool's refcounts were checked."""
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplerConfig

    serves = {}
    for key, sv in spec["serves"].items():
        for where in ("mesh", "one"):
            if where == "one" and (rank != 0 or not sv.get("one")):
                continue
            kw = {k: sv[k] for k in ("page_size", "prefix_cache", "prefill_chunk") if k in sv}
            if sv.get("spec_k"):
                kw.update(spec_k=sv["spec_k"], draft_executor=draft,
                          draft_device=0 if where == "mesh" else None)
            eng = ServingEngine(executors[(sv["name"], "kernel", where)],
                                max_batch=spec["max_batch"], max_len=sv["max_len"],
                                scheduler=sv["scheduler"],
                                sampler=SamplerConfig(temperature=sv["temperature"]), **kw)
            for i, prompt in enumerate(spec[sv["prompts"]]):
                eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=spec["max_new"]))
            tokens = {r.uid: r.output for r in eng.run()}
            if eng.pool is not None:
                eng.pool.check()
            serves[f"{where}:{key}"] = {"tokens": tokens, "stats": dict(eng.stats),
                                        "pool_checked": eng.pool is not None}
    return serves


def main():
    rank, port, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import (_leaves, init_params, local_bytes, place_params,
                                           params_from_numpy)
    from repro_torch.models.sharding import make_rules
    from repro_torch.serving.engine import ServingEngine, TransformerExecutor

    spec = json.loads((tmp / "inputs.json").read_text())
    rules = make_rules(make_test_mesh(model=2, data=1), "prefill")
    from repro_torch.models import rglru

    log_depth = []
    counted(rglru, "_scan_log_depth", log_depth)
    tokens = np.array(spec["tokens"])
    lengths = np.array(spec["lengths"])
    steps = spec["steps"]
    logits, report = {}, {}

    def run(ex):
        cache = ex.make_cache(tokens.shape[0], tokens.shape[1] + len(steps))
        out, cache = ex.prefill(tokens, cache, lengths=lengths)
        outs = [out]
        for i, step in enumerate(steps):
            out, cache = ex.decode(np.array(step)[:, None], cache, tokens.shape[1] + i)
            outs.append(out)
        return np.stack([o.detach().numpy() for o in outs])

    # the wave protocol (prefill with lengths, lockstep decode) of each
    # wave case; the paged protocol of each paged case, with the
    # collectives its calls stage
    pg = spec["paged"]
    executors = {}
    for case in spec["cases"]:
        name = case["name"]
        cfg = dataclasses.replace(reduced(get_config(case["arch"])), **case["over"])
        rep = {}
        p = params_from_numpy(unflatten(dict(np.load(tmp / f"{name}.npz"))))
        dp = place_params(p, cfg, rules)
        for backend in ("kernel", "eager"):
            one = TransformerExecutor(p, cfg, backend=backend)
            ex = TransformerExecutor(dp, cfg, backend=backend, rules=rules)
            executors[(name, backend, "one")], executors[(name, backend, "mesh")] = one, ex
            if name in spec["wave_names"]:
                logits[f"{name}/{backend}/one"] = run(one)
                take(log_depth)
                logits[f"{name}/{backend}/mesh"] = run(ex)
                rep[f"{backend}_calls"] = take(log_depth)
            if name in pg["names"]:
                # (the tests read rank 0's one-process calls only)
                for where, e in (("one", one), ("mesh", ex))[rank:]:
                    take(log_depth)
                    outs, pool = paged_calls(e, pg)
                    if where == "mesh":
                        rep[f"{backend}_paged_calls"] = take(log_depth)
                    for i, out in enumerate(outs):
                        logits[f"{name}/{backend}/{where}/paged{i}"] = out
                    for key, leaf in whole_leaves(pool).items():
                        logits[f"{name}/{backend}/{where}/pool/{key}"] = leaf
        if name in pg["names"]:
            rep["comms"] = paged_comms(executors[(name, "kernel", "mesh")], pg)
        if name in spec["wave_names"]:
            whole = init_params(cfg, generator=torch.Generator().manual_seed(0))
            shards = init_params(cfg, generator=torch.Generator().manual_seed(0), rules=rules)
            rep.update(init_unequal=["/".join(path) for (path, a), (_, b)
                                     in zip(_leaves(whole), _leaves(shards))
                                     if not torch.equal(a, b.full_tensor())],
                       init_local_bytes=local_bytes(shards), init_bytes=local_bytes(whole))
        report[name] = rep

    # the engine: waves greedy and sampled, the continuous scheduler, with
    # the prefix cache and chunks, and speculative decoding with the draft
    # on rank 0 alone
    draft_cfg = reduced(get_config(spec["draft"]))
    draft = (TransformerExecutor(init_params(draft_cfg, generator=torch.Generator().manual_seed(3)),
                                 draft_cfg) if rank == 0 else None)
    report["serves"] = serve_all(spec, executors, draft, rank)

    # the paged protocol under the mesh, call by call, on an arch the zoo pages
    ex = executors[(spec["paged_case"], "kernel", "mesh")]
    pool = ex.make_pool(4, 4)
    calls = {"make_pool": lambda: ex.make_pool(4, 4),
             "prefill_paged": lambda: ex.prefill_paged([[1, 2]], pool, [1], 2),
             "prefill_chunk": lambda: ex.prefill_chunk([[3]], pool, [1], offset=2, length=3),
             "decode_paged": lambda: ex.decode_paged([[1]], pool, [[1]], [3]),
             "continuous": lambda: ServingEngine(ex, scheduler="continuous")}
    report["paged_calls"] = {"supports_paged": ex.supports_paged}
    for what, fn in calls.items():
        report["paged_calls"][what] = describe(fn())
    report["staged"] = staged_collectives(rules.mesh.get_group("model").group_name)

    np.savez(tmp / f"rank{rank}.npz", **logits)
    (tmp / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
