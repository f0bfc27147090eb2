"""Multi-pod dry-run on ``meta`` tensors: price every (arch x shape x mesh)
cell (the port's ``repro.launch.dryrun``).

For each cell this builds the production step — the train step (loss,
backward and AdamW), serve prefill or serve decode — of ONE rank of the
16 x 16 single-pod or 2 x 16 x 16 multi-pod mesh, and runs it eagerly on
``meta`` tensors (shape and type, no storage, no card and no process
group): the model on ``runtime.mesh.AbstractMesh.at(rank)``, a
:class:`~repro_torch.runtime.mesh.PricedRank` that holds exactly the
rank's block of every parameter, moment and cache leaf and whose
collectives are recorded, not sent.  ``roofline.op_cost`` counts the
program op by op (FLOPs, HBM bytes, the live bytes' peak) and prices the
recorded collectives by the ring model; ``roofline.analyze_program``
derives the three roofline terms against an H100's peaks.

The reference instead compiles an SPMD program for 256/512 placeholder
devices (``XLA_FLAGS`` set at import) and reads XLA's optimized HLO and
``memory_analysis``.  Here there is no HLO and no placeholder device, and:

* ``trace_s`` (the time to run the rank's program on ``meta``) replaces
  ``lower_s``/``compile_s``;
* ``memory`` holds ``argument_bytes`` (the rank's state, batch block and
  cache block), ``output_bytes`` and ``peak_bytes`` (the traced live
  bytes, arguments included).  XLA's ``temp_bytes``, ``alias_bytes`` and
  ``code_bytes`` have no counterpart.  The port's train step leaves the
  state it is given as it was (no donation), so a train cell's peak holds
  the old and the new state together;
* the batch a rank is given is its block (the reference's ``in_shardings``
  of ``input_specs``), presented in the whole batch's shape the model's
  API takes: a ``meta`` view over a storage of the block's bytes, of
  which the model reads only the rank's block.

The paper's own workload — distributed Contour connectivity over a
paper-scale graph (2^28 vertices, 2^31 edges) — runs as an extra "arch"
(``contour-cc``).  Its step runs hand-written kernels through ``ctypes``
(which no dispatch mode sees) and reads its loop state on the host, so
it cannot run on ``meta``: its round is priced from the kernels' own
work (``blocked.fused_relax_work``, ``converged.pointer_jump_work``,
``converged.converged_early_work``, the bounds ``chip_smoke.py`` prints)
over the rank's edge block, with the labels' and the flag's
``all_reduce(MIN)`` on the priced rank, times ``CONTOUR_ROUNDS``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs
from repro_torch.configs.base import ArchSpec
from repro_torch.kernels.contour_mm import blocked
from repro_torch.kernels.contour_mm import converged as cv
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common as cm
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.roofline import analyze_program, model_flops
from repro_torch.roofline.op_cost import Cost, Memory, price
from repro_torch.runtime import mesh as rt
from repro_torch.train.step import TrainState, make_train_step

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")

# Paper-scale contour graph for the contour-cc cells.
CONTOUR_N_VERTICES = 1 << 28          # 268M vertices (kmer_V1r: 214M)
CONTOUR_N_EDGES = 1 << 31             # 2.1B directed relaxations
# the reference's lower_contour: local_rounds=1, max_iters=8 (Theorem-1's
# round budget for suite-scale diameters: Fig. 1 shows C-2 <= 7
# everywhere), the expected convergence rounds, not a safety bound
CONTOUR_ROUNDS = 8


def _mesh_and_name(which: str):
    if which == "single":
        return make_production_mesh(multi_pod=False), "pod1x16x16"
    return make_production_mesh(multi_pod=True), "pod2x16x16"


def _batch_axes(key: str, t) -> tuple:
    if key in ("tokens", "labels", "loss_mask"):
        return ("batch",) + (None,) * (len(t.shape) - 1)
    # patch_embeds / frame_embeds: (B, T, d)
    return ("batch", None, None)


def input_block(t: torch.Tensor, axes: tuple, config, rank) -> torch.Tensor:
    """The rank's block of the whole ``meta`` input ``t`` (its logical
    ``axes`` resolved on ``rank``'s mesh), presented in ``t``'s shape: a
    view over a storage of the block's bytes (``meta`` tensors hold no
    data, so the view may reach past it)."""
    spec = cm.resolve_spec(tuple(t.shape), axes, rank,
                           cm.make_rules(config, rank))
    block = cm.Sharding(rank, spec).shard_shape(tuple(t.shape))
    held = torch.empty(block, dtype=t.dtype, device="meta")
    return held.as_strided(tuple(t.shape), t.stride())


def rank_batch(arch: ArchSpec, shape_name: str, config, rank) -> Dict:
    """The rank's block of each of ``input_specs``' tensors."""
    return {k: input_block(t, _batch_axes(k, t), config, rank)
            for k, t in input_specs(arch, shape_name).items()}


# ---------------------------------------------------------------------------
# Cell programs: (the rank's step, its arguments), and their price
# ---------------------------------------------------------------------------

def train_program(arch: ArchSpec, shape, rank) -> tuple:
    """The train step (loss, backward, AdamW) of ``rank``: its state
    (moments bf16 where the parameters are, else float32) and batch
    block."""
    config = arch.config
    model = build_model(config, rank)
    opt = OptConfig(moment_dtype=(torch.bfloat16
                                  if config.param_dtype == torch.bfloat16
                                  else torch.float32))
    multi = "pod" in rank.axis_names
    step = make_train_step(model, opt, grad_accum=arch.accum_for(multi))
    params = model.params()
    state = TrainState(params=params, opt=init_opt_state(params, opt))
    return step, (state, rank_batch(arch, shape.name, config, rank))


def prefill_program(arch: ArchSpec, shape, rank) -> tuple:
    config = arch.config.for_serving()
    model = build_model(config, rank)
    return model.prefill, (model.params(),
                           rank_batch(arch, shape.name, config, rank))


def decode_program(arch: ArchSpec, shape, rank) -> tuple:
    """One token against a ``seq_len``-deep cache from ``init_cache``
    (its blocks as ``transformer.cache_shardings`` place them)."""
    config = arch.config.for_serving()
    model = build_model(config, rank)
    b = shape.global_batch
    if config.family == "audio":
        cache = model.init_cache(b, shape.seq_len, src_len=arch.src_frames)
    else:
        cache = model.init_cache(b, shape.seq_len)
    tokens = input_block(input_specs(arch, shape.name)["tokens"],
                         ("batch", None), config, rank)
    return model.decode_step, (model.params(), tokens, cache)


PROGRAMS = {"train": train_program, "prefill": prefill_program,
            "decode": decode_program}


def trace_cell(arch: ArchSpec, shape, rank) -> tuple:
    """(Cost, Memory) of the cell's program on ``rank``, run on ``meta``
    tensors (the reference's ``lower_*`` then ``compile``)."""
    fn, args = PROGRAMS[shape.kind](arch, shape, rank)
    _, cost, memory = price(fn, *args, mesh=rank)
    return cost, memory


def contour_round(n: int, m: int) -> Dict[str, Any]:
    """One global round of the distributed dense loop
    (``connectivity.distributed._dense_loop``, ``local_rounds=1``) on a
    rank with ``m`` edges and all ``n`` labels: the order-2 sweep (K1), a
    pointer-jump round (K7) and the early test (K6), each the kernel's
    (bytes, operations) as its bound counts them."""
    work = {"fused_relax": blocked.fused_relax_work(n, m),
            "pointer_jump": cv.pointer_jump_work(n),
            "converged_early": cv.converged_early_work(n, m)}
    return {"n": n, "m": m,
            "kernels": {k: {"bytes": b, "ops": o}
                        for k, (b, o) in work.items()},
            "bytes": sum(b for b, _ in work.values()),
            "ops": sum(o for _, o in work.values())}


def trace_contour(rank, n: int = CONTOUR_N_VERTICES,
                  m: int = CONTOUR_N_EDGES,
                  rounds: int = CONTOUR_ROUNDS) -> tuple:
    """(Cost, Memory, the round) of ``rounds`` rounds of the distributed
    dense loop on ``rank``: the edges block-sharded over ``("pod",
    "data")`` where the mesh has a ``pod`` axis, else ``("data",)``
    (padded to a multiple of the shard count), the labels replicated.
    FLOPs stay 0 (the kernels do int32 min and compare work, in the
    round's ``ops``).  The peak is the edge block and two label arrays (a
    sweep's or a jump's input and output), from the loop's code."""
    edge_axes = ("pod", "data") if "pod" in rank.axis_names else ("data",)
    m_rank = -(-m // rank.n_shards(edge_axes))
    work = contour_round(n, m_rank)
    start = len(rank.records)
    labels = torch.empty(n, dtype=torch.int32, device="meta")
    flag = torch.empty(1, dtype=torch.int32, device="meta")
    for _ in range(rounds):
        rt.all_reduce(labels, rank, edge_axes, dist.ReduceOp.MIN)
        rt.all_reduce(flag, rank, edge_axes, dist.ReduceOp.MIN)
    cost = Cost(bytes=float(rounds * work["bytes"]), ops=3 * rounds)
    cost.add_collectives(rank.records[start:])
    memory = Memory(argument_bytes=8 * m_rank, output_bytes=4 * n,
                    peak_bytes=8 * m_rank + 2 * 4 * n)
    return cost, memory, work


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_cell(arch_name: str, shape_name: str, mesh_which: str,
             out_dir: str) -> Dict[str, Any]:
    """Price the cell on rank 0 (every rank runs the same program on
    blocks of the same shapes) and write its record."""
    mesh, mesh_name = _mesh_and_name(mesh_which)
    n_dev = mesh.size
    priced = mesh.at(0)
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
    }
    t0 = time.time()
    try:
        extra: Dict[str, Any] = {}
        if arch_name == "contour-cc":
            cost, memory, work = trace_contour(priced)
            extra["contour"] = {"rounds": CONTOUR_ROUNDS, "round": work}
            kind = "contour"
            mf = 0.0
            note = ("paper kernel: per-round work is O(m) scatter-min, "
                    "MODEL_FLOPS n/a (memory/collective bound by design); "
                    "priced from the kernels' work, not traced")
        else:
            arch = get_arch(arch_name)
            skip = arch.skip_reason(shape_name)
            if skip:
                rec.update(status="skipped", reason=skip)
                _write(rec, out_dir)
                return rec
            shape = SHAPES[shape_name]
            mf = model_flops(build_model(arch.config, device="meta"),
                             shape.kind, shape.seq_len, shape.global_batch)
            note = ""
            cost, memory = trace_cell(arch, shape, priced)
            kind = shape.kind
        t_trace = time.time() - t0
        report = analyze_program(
            cost, memory, arch=arch_name, shape=shape_name,
            mesh_name=mesh_name, kind=kind, n_devices=n_dev,
            model_flops_global=mf, note=note)
        print(f"[{arch_name} | {shape_name} | {mesh_name}] rank 0: "
              f"{cost.ops} ops, argument {memory.argument_bytes:.3e} B, "
              f"peak {memory.peak_bytes:.3e} B")
        print(f"  flops/dev={report.hlo_flops:.3e} "
              f"bytes/dev={report.hlo_bytes:.3e} "
              f"coll_link_bytes/dev={report.collective_link_bytes:.3e}")
        print(f"  roofline: compute={report.t_compute*1e3:.2f}ms "
              f"memory={report.t_memory*1e3:.2f}ms "
              f"collective={report.t_collective*1e3:.2f}ms "
              f"-> dominant={report.dominant}")
        rec.update(
            trace_s=round(t_trace, 2),
            memory={"argument_bytes": memory.argument_bytes,
                    "output_bytes": memory.output_bytes,
                    "peak_bytes": memory.peak_bytes},
            roofline=report.to_dict(), **extra)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[{arch_name} | {shape_name} | {mesh_which}] FAILED: {e}")
    _write(rec, out_dir)
    return rec


def _write(rec: Dict[str, Any], out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def all_cells():
    for arch_name in list(ARCHS) + ["contour-cc"]:
        shapes = list(SHAPES) if arch_name != "contour-cc" else ["graph_2e31"]
        for shape_name in shapes:
            yield arch_name, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a, s in all_cells():
            print(a, s)
        return

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape or "train_4k")])
    n_ok = n_skip = n_err = 0
    for arch_name, shape_name in cells:
        for mw in meshes:
            mesh_name = "pod1x16x16" if mw == "single" else "pod2x16x16"
            path = os.path.join(
                args.out, f"{arch_name}__{shape_name}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") == "ok":
                        continue
            rec = run_cell(arch_name, shape_name, mw, args.out)
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
            n_err += rec["status"] == "error"
    print(f"dry-run: ok={n_ok} skipped={n_skip} error={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
