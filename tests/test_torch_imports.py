"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or the JAX package ``repro``."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCANNED = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SCANNED,
                         ids=[str(p.relative_to(ROOT)) for p in SCANNED])
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_neither_jax_nor_repro():
    import repro_torch
    modules = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    for module in ("kernels.contour_mm.blocked", "kernels.contour_mm.fleet",
                   "connectivity.streaming",
                   "connectivity.oocore", "connectivity.resilience",
                   "checkpoint.manager", "runtime.recovery",
                   "runtime.straggler", "serving.engine", "serving.client",
                   "serving.simulate", "data.dedup", "connectivity.batch",
                   "connectivity.planner.cache",
                   "connectivity.planner.autotune",
                   "connectivity.planner.costmodel",
                   "connectivity.distributed", "runtime.mesh",
                   "runtime.elastic", "data.pipeline", "models.common",
                   "models.attention", "models.mlp", "models.transformer",
                   "models.model", "configs.base",
                   "configs.mistral_nemo_12b", "launch.serve",
                   "optim.adamw", "train.step", "launch.train",
                   "launch.mesh", "roofline.analysis",
                   "roofline.op_cost", "launch.dryrun"):
        assert f"repro_torch.{module}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
