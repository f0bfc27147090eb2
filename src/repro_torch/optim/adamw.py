"""AdamW with a warmup-cosine schedule, global-norm clipping and
dtype-configurable moments (the port's ``repro.optim.adamw``; bfloat16
moments halve the optimizer's memory).

Parameters, gradients and moments are trees of tensors in the
reference's layout (``repro_torch.models.common``'s order: dict keys
sorted, lists in order).  The schedule and the bias corrections are
float32 tensors computed from the int32 ``step`` on its device, as the
reference computes them (a float64 ``lr`` or ``b1 ** step`` would move
every parameter in its last bits), so a step reads nothing back to the
host.  The update runs leaf by leaf in float32 and is cast back to the
parameter's and the moments' types; :func:`apply_updates` returns new
tensors and leaves its inputs as they were.

On a mesh the trees hold each rank's blocks and ``shardings`` (the
model's ``shardings_for`` tree) says how: :func:`global_norm` sums a
leaf's local squares over the axes that shard that leaf only, so a
replicated leaf counts once and every rank clips by the same scale; the
update itself is elementwise on the blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32   # bfloat16 for memory-tight configs


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def learning_rate(step: torch.Tensor, config: OptConfig) -> torch.Tensor:
    """The schedule at ``step`` (an integer tensor): a float32 scalar."""
    step = step.to(torch.float32)
    warm = config.peak_lr * step / max(config.warmup_steps, 1)
    prog = torch.clamp(
        (step - config.warmup_steps)
        / max(config.decay_steps - config.warmup_steps, 1), 0.0, 1.0)
    cos = config.min_lr + 0.5 * (config.peak_lr - config.min_lr) * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < config.warmup_steps, warm, cos)


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor)


def init_opt_state(params, config: OptConfig) -> Dict[str, Any]:
    """Zero moments in ``config.moment_dtype`` beside each leaf, and an
    int32 ``step`` of 0 on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=config.moment_dtype,
                           device=p.device)

    leaves = cm.tree_leaves_with_path(params, _is_leaf)
    device = leaves[0][1].device if leaves else None
    return {"m": cm.tree_map(zeros, params, _is_leaf),
            "v": cm.tree_map(zeros, params, _is_leaf),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf by leaf in the tree's
    order.  With ``shardings`` the leaves are summed in that order within
    each set of axes that shards them, each set's local sum reduced over
    the ranks of its axes in one all-reduce (a replicated leaf counts
    once), and the sets added in the order they first occur; on one rank
    that is the mesh-less sum."""
    from repro_torch.runtime import mesh as rt
    sh = {} if shardings is None else dict(cm.tree_leaves_with_path(
        shardings, lambda x: isinstance(x, cm.Sharding)))
    sums: Dict[tuple, Any] = {}
    mesh = None
    for path, x in cm.tree_leaves_with_path(tree, _is_leaf):
        axes = ()
        if path in sh:
            mesh = sh[path].mesh
            held = {a for dim in sh[path].layout(x.dim()) for a in dim}
            axes = tuple(a for a in mesh.axis_names if a in held)
        square = torch.sum(torch.square(x.to(torch.float32)))
        sums[axes] = sums[axes] + square if axes in sums else square
    total = 0
    for axes, square in sums.items():
        total = total + (rt.all_reduce(square, mesh, axes) if axes
                         else square)
    return torch.sqrt(total)


def apply_updates(params, grads, opt_state, config: OptConfig,
                  shardings=None):
    """One AdamW step. Returns (params, opt_state, metrics), all new.
    ``shardings``: the parameters' on a mesh (for the norm)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(config.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = learning_rate(step, config)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(config.b1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_f32(config.b2, stepf), stepf)
    f32 = torch.float32

    def upd(p, g, m, v):
        g = g.to(f32) * scale
        m_new = config.b1 * m.to(f32) + (1 - config.b1) * g
        v_new = config.b2 * v.to(f32) + (1 - config.b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + config.eps)
        update = update + config.weight_decay * p.to(f32)
        p_new = p.to(f32) - lr * update
        return (p_new.to(p.dtype), m_new.to(config.moment_dtype),
                v_new.to(config.moment_dtype))

    g_of = dict(cm.tree_leaves_with_path(grads, _is_leaf))
    m_of = dict(cm.tree_leaves_with_path(opt_state["m"], _is_leaf))
    v_of = dict(cm.tree_leaves_with_path(opt_state["v"], _is_leaf))
    out = {path: upd(p, g_of[path], m_of[path], v_of[path])
           for path, p in cm.tree_leaves_with_path(params, _is_leaf)}

    def part(i):
        return cm.tree_map_with_path(lambda path, _: out[path][i], params,
                                     _is_leaf)

    new_state = {"m": part(1), "v": part(2), "step": step}
    return part(0), new_state, {"lr": lr, "grad_norm": gnorm}
