"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, and its entry points refuse to run on the CPU unless asked."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_reference_out():
    """Importing the port and every submodule, in a fresh interpreter, puts
    neither ``jax`` nor ``repro`` in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    assert int(res.stdout.strip()) >= 20  # every submodule was imported


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _is_forbidden(name), f"{path}: imports {name}"


@pytest.mark.parametrize("entry", ["serve", "main", "trace_main", "zoo_main"])
def test_entry_point_refuses_cpu_fallback(monkeypatch, entry):
    """Without CUDA, the serving entry points raise unless device='cpu'."""
    from repro_torch import resolve_device
    from repro_torch.launch import serve, trace_serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "serve":
            serve.serve()
        elif entry == "main":
            serve.main(["--requests", "1"])
        elif entry == "zoo_main":
            serve.main(["--executor", "zoo", "--model", "recurrentgemma-9b",
                        "--reduce", "--requests", "1"])
        else:
            trace_serve.main(["--requests", "1"])
    assert resolve_device("cpu").type == "cpu"
