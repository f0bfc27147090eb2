"""The control and the planted faults that ``correct`` must catch.

Each plant replaces part of the program for the length of a ``with``
block; a run of a cell under it has to come out not correct.

* ``control``: the plain reference put in the program's place, with one
  guarantee of the configurations broken: each component labelled by
  its greatest vertex id, not its least (the same partition).
* ``state_unchanged``: the Contour step returns its labels unchanged.
* ``answer_altered``: one label of every result is changed where the
  result is made.

On the card, ``python3 portbench/controls.py --workload <name> --seeds
<s> ... --seconds <t>`` runs the cell under the control at its own size
on each seed and prints each run's checks; the CPU tests run every plant
at small sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import torch

if __package__ in (None, ""):
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import reference  # noqa: E402


def greatest_id_labels(src: torch.Tensor, dst: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Each vertex's component labelled by its greatest vertex id."""
    flip = n - 1
    least = reference.components(flip - src, flip - dst, n)
    return flip - least.flip(0)


def _control_solve(graph, options=None, **kw):
    labels = greatest_id_labels(graph.src, graph.dst, graph.n_vertices)
    return SimpleNamespace(
        labels=labels, iterations=torch.ones((), device=labels.device),
        converged=torch.ones((), dtype=torch.bool, device=labels.device),
        provenance=("control",))


@contextlib.contextmanager
def control():
    with mock.patch("repro_torch.solve", _control_solve):
        yield


def _unchanged_step(*args, **kwargs):
    def step(L, *rest, **kw):
        return L.clone()
    return step


@contextlib.contextmanager
def state_unchanged():
    with mock.patch("repro_torch.connectivity.contour._make_step",
                    _unchanged_step):
        yield


@contextlib.contextmanager
def answer_altered():
    # the module, not the function that the package exports by its name
    module = importlib.import_module("repro_torch.connectivity.solve")
    make_result = module.make_result

    def altered(labels, *args, **kwargs):
        labels = labels.clone()
        labels.view(-1)[-1] += 1
        return make_result(labels, *args, **kwargs)

    with mock.patch.object(module, "make_result", altered):
        yield


PLANTS = {"control": control, "state_unchanged": state_unchanged,
          "answer_altered": answer_altered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run a cell under a plant")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--plant", choices=sorted(PLANTS), default="control")
    args = p.parse_args(argv)
    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        with PLANTS[args.plant]():
            result = harness.run_cell(
                args.workload, seed, args.seconds, False,
                t_start=time.perf_counter(),
                log=lambda line: print(line, file=sys.stderr, flush=True))
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
