"""Build the CUDA C++ kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a``, then loaded with ``ctypes``.
All sources missing a build are compiled together, one ``nvcc`` process
each, so the build costs as long as the slowest file.  Libraries are named
by a digest of their source, of every ``csrc/`` header it includes
(``#include "<name>.cuh"``, followed through the headers' own includes),
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  The build directory is
``kernels/_build/`` (listed in ``.gitignore``); ``ptxas``'s register and
shared-memory report for each source is kept there as ``<name>.log``.  A
build holds a file lock on ``_build/.lock`` as well as a thread lock, so
processes that start together (the ranks of a ``ProcessRing``) compile
each source once: the first builds, the others wait and find it built.
:func:`sm_count` gives the launch plans the device's SM count.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("tiled_gemm_valid", "ragged_flash_attention", "fused_connective",
           "flash_attention", "rglru_scan", "tiled_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # loaded CUDA libraries
_sm_counts: Dict[int, int] = {}  # per device index


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly
    or through another header, in the order first met."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo.extend(CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes()))
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """This process's thread lock, then the build directory's file lock
    (released when the process ends, however it ends)."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> Dict[str, float]:
    """Compile every source that has no current library, in parallel.

    Returns the seconds each compiled source took (empty when all were
    built already, here or by another process).  Raises ``RuntimeError``
    with the compiler's output if any build fails.
    """
    if all(_target(n).exists() for n in SOURCES):
        return {}  # a library appears whole (os.replace) or not at all
    with _build_lock():
        todo = [n for n in SOURCES if not _target(n).exists()]
        if not todo:
            return {}
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs: Dict[str, Tuple[subprocess.Popen, Path]] = {}
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        seconds: Dict[str, float] = {}
        failures = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _target(name))
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        return seconds


def load(name: str, signatures: Dict[str, Tuple[Optional[type], list]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with the
    given ``{function: (restype, argtypes)}`` declared."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: the kernel would be built and loaded while a CUDA "
                           "graph is captured; warm up first: run the step once eagerly "
                           "before capturing it")
    build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
    return lib


def build_log(name: str) -> str:
    """``nvcc``/``ptxas`` output of the last build of ``name``."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


_FUNCTION = re.compile(r"Function properties for (\S+)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def spills(log: str) -> Dict[str, Tuple[int, int]]:
    """Bytes of spill stores and loads that ``ptxas -v`` reports in a build
    log for each function, by its mangled name."""
    out: Dict[str, Tuple[int, int]] = {}
    function = None
    for line in log.splitlines():
        m = _FUNCTION.search(line)
        if m:
            function = m.group(1)
            continue
        m = _SPILLS.search(line)
        if m and function is not None:
            out[function] = (int(m.group(1)), int(m.group(2)))
            function = None
    return out


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device``, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]
