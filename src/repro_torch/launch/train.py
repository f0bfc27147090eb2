"""Training loop: data pipeline + recovery loop + checkpointing + metrics.

The port's counterpart of ``repro.launch.train``.  It runs real steps on
the card (or on the CPU where ``device="cpu"`` is named), eager: atomic
keep-k checkpoints, restore on start, seekable data (batch k is a pure
function of k), straggler monitoring.  On a mesh (``mesh=``; from the
command line, ``torchrun`` with more than one rank, ``--tp`` ranks on
the model axis) every rank runs the same loop on its blocks of the
state and the whole batch; checkpoints are written whole by the mesh's
first rank and restored block by block.

Usage::

  python -m repro_torch.launch.train --arch olmo-1b --smoke --steps 50
  python -m repro_torch.launch.train --arch xlstm-125m --smoke --steps 20 \\
      --device cpu
  python -m repro_torch.launch.train --arch <id> --steps 200 --ckpt-dir ck
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --tp 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.graphs.structs import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train.step import (init_train_state, make_train_step,
                                    train_state_shardings)


def build_batch_fn(config, batch: int, seq: int, seed: int = 0,
                   device: DeviceLike = None):
    """``batch_at(step)``: the reference's batch of ``step`` as tensors on
    ``device`` (the card unless one is named); the frontends' stub
    embeddings are drawn from ``default_rng([7, seed, step])`` /
    ``[11, seed, step]`` in float32, as the reference draws them."""
    pipe = SyntheticTokenPipeline(
        vocab_size=config.vocab_size, batch=batch, seq_len=seq, seed=seed)
    dev = resolve_device(device)

    def batch_at(step: int) -> Dict[str, Any]:
        b = pipe.batch_at(step)
        out = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        if config.frontend == "patch_stub":
            n = min(config.n_frontend_tokens, seq)
            rng = np.random.default_rng([7, seed, step])
            out["patch_embeds"] = torch.as_tensor(
                rng.standard_normal((batch, n, config.d_model), np.float32),
                device=dev)
        if config.frontend == "audio_stub":
            rng = np.random.default_rng([11, seed, step])
            out["frame_embeds"] = torch.as_tensor(
                rng.standard_normal((batch, max(seq // 2, 4),
                                     config.d_model), np.float32),
                device=dev)
        return out

    return batch_at


def train_loop(
    config,
    *,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: Optional[str] = None,
    checkpoint_every: int = 20,
    grad_accum: int = 1,
    mesh=None,
    opt: Optional[OptConfig] = None,
    seed: int = 0,
    log_every: int = 10,
    on_step=None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Run ``steps`` steps; returns summary metrics (resumes from
    ``ckpt_dir``).  The parameters are drawn from a ``torch.Generator``
    seeded with ``seed`` on the device (JAX's draws do not carry over; a
    checkpoint of either package does).  On a ``mesh`` (a
    ``repro_torch.runtime.Mesh``; the device defaults to its own) every
    rank of it must call this; the state is the rank's blocks and only
    the mesh's first rank logs."""
    opt = opt or OptConfig(warmup_steps=max(steps // 10, 1),
                           decay_steps=max(steps, 2))
    model = build_model(config, mesh, device=device)
    shardings = train_state_shardings(model)
    if mesh is not None and mesh.rank != int(mesh.devices.flat[0]):
        log_every = 0
    step_fn = make_train_step(model, opt, grad_accum=grad_accum)
    batch_at = build_batch_fn(config, batch, seq, seed, device=model.device)

    state = init_train_state(
        model, torch.Generator(device=model.device).manual_seed(seed), opt)
    start = 0
    manager = None
    if ckpt_dir is not None:
        manager = CheckpointManager(ckpt_dir, keep=3, async_save=False)
        latest = manager.latest_step()
        if latest is not None:
            state, restored = manager.restore(state, device=model.device,
                                              shardings=shardings)
            start = restored + 1

    monitor = StragglerMonitor()
    losses = []
    t0 = time.time()
    for k in range(start, steps):
        monitor.start_step()
        # the old state is dropped here (the reference donates it)
        state, metrics = step_fn(state, batch_at(k))
        loss = float(metrics["loss"])
        action = monitor.end_step()
        losses.append(loss)
        if on_step is not None:
            on_step(k, state, metrics)
        if manager is not None and ((k + 1) % checkpoint_every == 0
                                    or k == steps - 1):
            manager.save(k, state, shardings)
            manager.wait()
        if log_every and (k % log_every == 0 or k == steps - 1):
            print(f"step {k:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"[{action}]")
    wall = time.time() - t0
    return {
        "steps_run": steps - start,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": wall,
        "state": state,
        "step_times": monitor.history,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    config = arch.smoke_config() if args.smoke else arch.config
    mesh = host_mesh(args.tp, args.device)
    first = mesh is None or mesh.rank == 0
    try:
        out = train_loop(config, steps=args.steps, batch=args.batch,
                         seq=args.seq, ckpt_dir=args.ckpt_dir,
                         grad_accum=args.grad_accum, mesh=mesh,
                         device=args.device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    out.pop("state")
    if first:
        print(json.dumps({k: v for k, v in out.items()
                          if k != "step_times"}, indent=1))


def host_mesh(tp: int, device: DeviceLike = None):
    """``make_host_mesh(tp)`` over the ranks ``torchrun`` started (the
    process group initialised here from its environment: ``nccl`` on the
    card, ``gloo`` on the CPU) where there is more than one, else None
    (one rank trains alone, whatever ``tp`` says, as the reference does
    on one device)."""
    import os
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if not dist.is_initialized():
        cpu = device is not None and torch.device(device).type == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl")
    return make_host_mesh(tp, device=device)


if __name__ == "__main__":
    main()
