"""The harness on the card at small sizes: a traced run reads the port's
kernels, and every share stays at or under 100%.  Marked ``cuda``; skips
without a card.

    PYTHONPATH=src python -m pytest -q -m cuda portbench/
"""
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402
from portbench.test_portbench_drive import SMALL  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return "cuda"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_run_on_the_card(cuda, name):
    result = harness.run_cell(name, 2 ** 31 + 21, 0.5, True,
                              t_start=time.perf_counter(), device=cuda,
                              sizes=SMALL[name],
                              log=lambda line: None)
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["kernel_ms"]["value"] > 0
    for key, m in metrics.items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, key
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
