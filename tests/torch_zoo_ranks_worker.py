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


def main():
    rank, port, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import (_leaves, init_params, local_bytes, place_params,
                                           params_from_numpy)
    from repro_torch.models.sharding import make_rules
    from repro_torch.serving.engine import (Request, ServingEngine, TransformerExecutor)
    from repro_torch.serving.sampler import SamplerConfig

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

    executors = {}
    for case in spec["cases"]:
        name = case["name"]
        cfg = dataclasses.replace(reduced(get_config(case["arch"])), **case["over"])
        whole = init_params(cfg, generator=torch.Generator().manual_seed(0))
        shards = init_params(cfg, generator=torch.Generator().manual_seed(0), rules=rules)
        rep = {"init_unequal": ["/".join(path) for (path, a), (_, b)
                                in zip(_leaves(whole), _leaves(shards))
                                if not torch.equal(a, b.full_tensor())],
               "init_local_bytes": local_bytes(shards), "init_bytes": local_bytes(whole)}
        p = params_from_numpy(unflatten(dict(np.load(tmp / f"{name}.npz"))))
        dp = place_params(p, cfg, rules)
        for backend in ("kernel", "eager"):
            logits[f"{name}/{backend}/one"] = run(TransformerExecutor(p, cfg, backend=backend))
            take(log_depth)
            ex = TransformerExecutor(dp, cfg, backend=backend, rules=rules)
            logits[f"{name}/{backend}/mesh"] = run(ex)
            rep[f"{backend}_calls"] = take(log_depth)
            executors[(name, backend)] = ex
        report[name] = rep

    # the wave engine on the mesh, greedy and sampled
    serves = {}
    for name, temperature, scheduler in spec["serves"]:
        eng = ServingEngine(executors[(name, "kernel")], max_batch=spec["max_batch"],
                            max_len=spec["max_len"], scheduler=scheduler,
                            sampler=SamplerConfig(temperature=temperature))
        for i, prompt in enumerate(spec["prompts"]):
            eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=spec["max_new"]))
        serves[f"{name}@{temperature}@{scheduler}"] = {
            "tokens": {r.uid: r.output for r in eng.run()},
            "decode_steps": eng.stats["decode_steps"],
            "prefill_waves": eng.stats["prefill_waves"]}
    report["serves"] = serves

    # what a mesh refuses, on an arch the zoo pages on one process
    ex = executors[(spec["paged_case"], "kernel")]
    refusals = {"supports_paged": ex.supports_paged}
    calls = {"make_pool": lambda: ex.make_pool(4, 4),
             "prefill_paged": lambda: ex.prefill_paged([[1, 2]], None, [0], 2),
             "prefill_chunk": lambda: ex.prefill_chunk([[1, 2]], None, [0], offset=0, length=2),
             "decode_paged": lambda: ex.decode_paged([[1]], None, [[0]], [0]),
             "continuous": lambda: ServingEngine(ex, scheduler="continuous")}
    for what, fn in calls.items():
        try:
            fn()
            refusals[what] = None
        except (NotImplementedError, ValueError) as e:
            refusals[what] = f"{type(e).__name__}: {e}"
    report["refusals"] = refusals
    report["staged"] = staged_collectives(rules.mesh.get_group("model").group_name)

    np.savez(tmp / f"rank{rank}.npz", **logits)
    (tmp / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
