"""``correct`` comes out false under the control and under each planted
fault a cell can have, with the run driven as on the card but for the
look for a card (CPU, ``backend="torch"``, toy sizes)."""
import pytest

torch = pytest.importorskip("torch")

from portbench import controls  # noqa: E402
from portbench.test_portbench_drive import SMALL, run_small  # noqa: E402

# the faults each cell can have: every cell solves one whole graph on
# one chip, so none has a batch to halve or an exchange to leave out
PLANTS = {
    "graph500-kron.s26-solve": ["control", "state_unchanged",
                                "answer_altered"],
    "dimacs10-rgg.n24-solve": ["control", "state_unchanged",
                               "answer_altered"],
}
CASES = [(name, plant) for name in sorted(PLANTS) for plant in PLANTS[name]]


def test_every_cell_is_planted():
    assert sorted(PLANTS) == sorted(SMALL)
    from portbench import harness
    cells = {w["name"] for w in harness.load_spec()["workloads"]}
    assert cells == set(PLANTS)


@pytest.mark.parametrize("name,plant", CASES)
def test_plant_is_caught(name, plant):
    with controls.PLANTS[plant]():
        result = run_small(name, options_extra={"max_iters": 64})
    assert result["correct"] is False
    checks = result["checks"]
    assert (checks["mismatched_labels"]["value"] > 0
            or checks["failed_calls"]["value"] > 0)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_same_run_unplanted_is_correct(name):
    result = run_small(name, options_extra={"max_iters": 64})
    assert result["correct"] is True
