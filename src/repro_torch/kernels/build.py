"""Build the CUDA C++ kernels of ``csrc/`` at first use and load them.

``csrc/`` also holds the Triton kernels (``csrc/<name>.py``), which import
``triton`` at their top; :func:`load_python` loads one at its first
launch, so no module of the package needs Triton to import.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a``, then loaded with ``ctypes``.
All sources missing a build are compiled together, one ``nvcc`` process
each, so the build costs as long as the slowest file.  Libraries are named
by a digest of their source and flags, so an edited source is rebuilt and
a stale library is never loaded.  The build directory is
``kernels/_build/`` (listed in ``.gitignore``); ``ptxas``'s register and
shared-memory report for each source is kept there as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("tiled_gemm_valid", "ragged_flash_attention", "flash_attention",
           "rglru_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, object] = {}  # loaded CUDA libraries and Triton modules


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every source that has no current library, in parallel.

    Returns the seconds each compiled source took (empty when all were
    built already).  Raises ``RuntimeError`` with the compiler's output if
    any build fails.
    """
    with _lock:
        todo = [n for n in SOURCES if not _target(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
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


def load_python(name: str):
    """The module ``csrc/<name>.py`` (a Triton kernel), loaded once."""
    key = f"{name}.py"
    mod = _libs.get(key)
    if mod is None:
        with _lock:
            mod = _libs.get(key)
            if mod is None:
                spec = importlib.util.spec_from_file_location(
                    f"repro_torch_csrc_{name}", CSRC / key)
                mod = importlib.util.module_from_spec(spec)
                sys.modules[spec.name] = mod
                spec.loader.exec_module(mod)
                _libs[key] = mod
    return mod


def build_log(name: str) -> str:
    """``nvcc``/``ptxas`` output of the last build of ``name``."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
