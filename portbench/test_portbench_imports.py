"""No benchmark run loads JAX or the JAX package ``repro``, compared by
whole top-level names (the port's ``repro_torch`` begins with
``repro``); and the command refuses to run without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# run.py's imports, then one toy drive of every cell, in a fresh process
REHEARSAL = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import runpy
run = runpy.run_path(sys.argv[1] + "/portbench/run.py", run_name="rehearsal")
from portbench import controls, harness
from portbench.test_portbench_drive import SMALL, run_small
for name in SMALL:
    assert run_small(name)["correct"]
    assert run_small(name, trace=True)["correct"]
print(json.dumps(harness.forbidden_modules()))
"""


def test_forbidden_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.connectivity", "reprox", "jaxtyping",
             "portbench.harness"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.connectivity"]) \
        == ["repro"]
    assert harness.forbidden_modules(["jax._src.core", "flax"]) \
        == ["flax", "jax"]


def test_a_rehearsal_loads_neither_jax_nor_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", REHEARSAL, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_command_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "graph500-kron.s26-solve", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
