"""One process per ring device: start the ranks, join them, stop them.

A :class:`~repro_torch.core.ring.ProcessRing` needs D processes in one
``torch.distributed`` group.  :func:`launch` starts them on this host, a
command per rank with ``--rank r --init-method tcp://127.0.0.1:<port>``
appended, and waits for all of them: if any rank fails or the time limit
passes, the others are stopped and the launch fails, so a fault never ends
as exit code 0.  :func:`init` is the rank's side: the gloo rendezvous (with
a timeout, so a missing peer fails instead of hanging), its device and its
ring.  Nothing here reads a cluster's environment; the address, world size
and rank are given.
"""
from __future__ import annotations

import argparse
import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.ring import ProcessRing, stage_mesh_collectives

#: seconds a rank waits at the rendezvous and in each collective
RENDEZVOUS_S = 120


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def add_rank_args(ap: argparse.ArgumentParser) -> None:
    """The arguments :func:`launch` gives each rank (not for users)."""
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)


def _stop(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class RankFailure(RuntimeError):
    """A rank exited non-zero, or the ranks outlived their time limit."""


def launch(cmd: Sequence[str], ranks: int, *, timeout: float,
           capture: bool = False) -> List[Tuple[int, str, str]]:
    """Run ``cmd`` as ``ranks`` processes joined by a gloo rendezvous on
    127.0.0.1; returns (exit code, stdout, stderr) per rank (the streams
    are "" unless ``capture``: then they are collected, else inherited).

    Raises :class:`RankFailure` when a rank exits non-zero (the others are
    stopped at once: they would wait for it in a collective) or when the
    ranks are not done within ``timeout`` seconds."""
    if ranks < 1:
        raise ValueError(f"--ranks must be >= 1, got {ranks}")
    init = f"tcp://127.0.0.1:{free_port()}"
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    pipe = subprocess.PIPE if capture else None
    procs = [subprocess.Popen([*cmd, "--rank", str(r), "--init-method", init], env=env,
                              stdout=pipe, stderr=pipe, text=True)
             for r in range(ranks)]
    outs = {}
    deadline = time.monotonic() + timeout

    def terminated(signum, frame):
        raise RankFailure(f"the launcher was sent signal {signum}")

    try:  # a launcher that is told to stop stops its ranks first
        prev = signal.signal(signal.SIGTERM, terminated)
    except ValueError:  # not the main thread: no handler can be set
        prev = None
    try:
        while len(outs) < ranks:
            for r, p in enumerate(procs):
                if r in outs:
                    continue
                if capture:
                    try:  # drain the pipes so a chatty rank never blocks
                        out, err = p.communicate(timeout=0.2)
                    except subprocess.TimeoutExpired:
                        continue
                elif p.poll() is None:
                    continue
                else:
                    out, err = "", ""
                outs[r] = (p.returncode, out or "", err or "")
                if p.returncode != 0:
                    raise RankFailure(f"rank {r} of {ranks} exited with code {p.returncode}"
                                      + (f":\n{err[-4000:]}" if err else ""))
            if len(outs) < ranks:
                if time.monotonic() > deadline:
                    raise RankFailure(f"ranks {sorted(set(range(ranks)) - set(outs))} of "
                                      f"{ranks} did not finish within {timeout:.0f} s")
                if not capture:
                    time.sleep(0.1)
    finally:
        _stop(procs)
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
    return [outs[r] for r in range(ranks)]


def init(rank: int, ranks: int, init_method: str, *, device=None,
         timeout: float = RENDEZVOUS_S) -> Tuple[ProcessRing, torch.device]:
    """Join the gloo group as ``rank`` of ``ranks`` and return this rank's
    ring and device: ``cuda:(rank % cards)`` unless ``device`` is "cpu"
    (then the ranks split the host's cores).  ``timeout`` bounds the
    rendezvous and every collective.  On CUDA the ``DTensor`` collectives
    of gloo groups are staged through host memory
    (``core/ring.stage_mesh_collectives``), as the ring's hops are."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:  # the ranks share this host's cores
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // ranks)))
    dist.init_process_group("gloo", init_method=init_method, world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    if dev.type == "cuda":
        stage_mesh_collectives()
    return ProcessRing(rank, ranks), dev


def finish() -> None:
    """Leave the group once every rank is done with it."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def python_module(module: str, argv: Sequence[str]) -> List[str]:
    """The command that runs ``python -m module argv`` in this interpreter."""
    return [sys.executable, "-m", module, *argv]
