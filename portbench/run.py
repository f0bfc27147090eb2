"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for; it fails, and prints no result, without them.  It measures
``repro_torch`` (the checkout's ``src``), builds the port's kernels into
the checkout (``build/kernels``), keeps the planner's tuning cache at a
fixed path under ``$TMPDIR`` and removes it first, so every run plans
from the heuristic table, and writes nothing else.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def environment() -> None:
    """Caches inside the checkout or under the run's ``TMPDIR``."""
    tuning = Path(tempfile.gettempdir()) / "portbench" / "tuning-cache.json"
    tuning.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(tuning)
    os.environ.pop("REPRO_TORCH_BENCH_ARTIFACT", None)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness

    workload = harness.find_workload(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(workload["chips"]):
        print(f"{args.workload} needs {workload['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T_START,
        log=lambda line: print(line, file=sys.stderr, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
