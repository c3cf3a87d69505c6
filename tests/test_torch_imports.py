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


@pytest.mark.parametrize("module", ["repro_torch.serving.spec", "repro_torch.serving.galaxy",
                                    "repro_torch.core.hmp", "repro_torch.launch.serve",
                                    "repro_torch.obs", "repro_torch.obs.metrics",
                                    "repro_torch.obs.trace", "repro_torch.obs.drift",
                                    "repro_torch.core.simulator",
                                    "repro_torch.core.profiler",
                                    "repro_torch.models.moe", "repro_torch.models.xlstm",
                                    "repro_torch.data", "repro_torch.training",
                                    "repro_torch.launch.train",
                                    "repro_torch.models.sharding", "repro_torch.launch.mesh",
                                    "repro_torch.launch.shapes", "repro_torch.launch.dryrun",
                                    "repro_torch.roofline.analysis",
                                    "repro_torch.roofline.counter",
                                    "repro_torch.roofline.report",
                                    "repro_torch.models.layers",
                                    "repro_torch.models.transformer",
                                    "repro_torch.experiments.hillclimb",
                                    "repro_torch.experiments.calibrate",
                                    "repro_torch.examples.quickstart",
                                    "repro_torch.examples.plan_heterogeneous",
                                    "repro_torch.examples.serve_collaborative",
                                    "repro_torch.examples.train_small",
                                    "repro_torch.core.ring", "repro_torch.launch.ranks",
                                    "repro_torch.launch.ring_times"])
def test_module_alone_leaves_jax_and_reference_out(module):
    """Each module of the Galaxy serving path and its telemetry, the zoo's MoE and
    xLSTM blocks, the training path (data, training, the trainer, dropout and remat),
    the multi-chip layout (sharding rules, meshes, shapes, the dry run and its
    roofline), the experiments (hillclimb, calibration), the examples, and the
    ring across processes (the process ring, its launcher and its timing script),
    imported alone in a fresh interpreter, pulls in neither ``jax`` nor ``repro``."""
    code = (
        f"import importlib, sys\nimportlib.import_module({module!r})\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout


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


@pytest.mark.parametrize("entry", ["serve", "main", "trace_main", "zoo_main", "spec_main",
                                   "telemetry_main", "host_profiler", "train_main",
                                   "train", "trace_train", "calibrate", "quickstart",
                                   "serve_collaborative", "train_small"])
def test_entry_point_refuses_cpu_fallback(monkeypatch, entry):
    """Without CUDA, the serving and training entry points, the calibration's
    measurement and the examples raise unless device='cpu'."""
    from repro_torch import resolve_device
    from repro_torch.launch import serve, trace_serve, trace_train, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "serve":
            serve.serve()
        elif entry == "main":
            serve.main(["--requests", "1"])
        elif entry == "spec_main":
            serve.main(["--draft-model", "distilbert", "--spec-k", "2", "--requests", "1"])
        elif entry == "telemetry_main":
            serve.main(["--requests", "1", "--trace", "unused.json", "--metrics", "--drift"])
        elif entry == "host_profiler":
            from repro_torch.configs import get_config
            from repro_torch.core.profiler import HostProfiler

            HostProfiler(get_config("distilbert"), 8)
        elif entry == "train_main":
            train.main(["--arch", "qwen1.5-0.5b", "--reduce", "--steps", "1"])
        elif entry == "train":
            from repro_torch.configs import get_config, reduced

            train.train(reduced(get_config("qwen1.5-0.5b")), steps=1)
        elif entry == "calibrate":
            from repro_torch.experiments import calibrate

            calibrate.main([])
        elif entry in ("quickstart", "serve_collaborative", "train_small"):
            import importlib

            importlib.import_module(f"repro_torch.examples.{entry}").main([])
        elif entry == "trace_train":
            trace_train.main(["--arch", "qwen1.5-0.5b", "--reduce", "--steps", "1"])
        elif entry == "zoo_main":
            serve.main(["--executor", "zoo", "--model", "recurrentgemma-9b",
                        "--reduce", "--requests", "1"])
        else:
            trace_serve.main(["--requests", "1"])
    assert resolve_device("cpu").type == "cpu"
