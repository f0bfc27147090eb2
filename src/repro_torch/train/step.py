"""The training step: grad, clip, AdamW, optional microbatch
accumulation (the port's ``repro.train.step``).

``make_train_step(model, opt_config, grad_accum)`` returns
``step(state, batch) -> (state, metrics)``.  The step takes the
parameter tree explicitly, as the reference's ``loss(params, batch)``
does: it makes a leaf that requires grad of each parameter (the same
storage), runs ``model.loss`` on that tree and takes the gradients with
``torch.autograd.grad`` over the leaves in the tree's order; no
``.grad`` buffer of the module is written.  Gradient accumulation splits
the global batch into ``grad_accum`` microbatches, run in order, and
sums their gradients in float32 from zeros (the reference's
``lax.scan``).

The step returns a new state and leaves the one it is given as it was
(``run_with_recovery`` restores with its ``init_state`` as the
template); only its caller can drop the old state, as the reference's
``donate_argnums=(0,)`` does in ``launch.train.train_loop``.  State
leaves and batch entries given as numpy arrays (a restored checkpoint,
the data pipeline's arrays) are taken onto the model's device.

On a mesh (a model built with one) the state holds the rank's blocks
and every rank is given the whole batch.  The gradient reductions of
``repro_torch.models.common``'s placement rule run inside the backward
(each weight's use sums its gradient over the axes it must), so
``torch.autograd.grad`` returns each rank its block of the global
gradient; the clip's norm sums each leaf over its own shard axes
(``optim.adamw.global_norm``).  The embedding's gradient is still summed
in float32.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state


class TrainState(NamedTuple):
    params: Any
    opt: Dict[str, Any]


def train_state_shardings(model) -> TrainState:
    """The shardings of ``model``'s train state on its mesh (None without
    one): the parameters' for the parameters and both moments, none for
    the step."""
    sh = getattr(model, "shardings", None)
    if sh is None:
        return None
    return TrainState(params=sh, opt={"m": sh, "v": sh, "step": None})


def init_train_state(model, generator: torch.Generator,
                     opt_config: OptConfig) -> TrainState:
    params = model.init(generator)
    return TrainState(params=params, opt=init_opt_state(params, opt_config))


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def on_device(tree, device):
    """``tree`` with its numpy leaves as tensors on ``device`` (tensors
    already there are kept, not copied)."""
    def take(x):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()           # torch takes no read-only array
        return torch.as_tensor(x, device=device)

    return cm.tree_map(take, tree, _is_leaf)


def _split_microbatches(batch, n: int):
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape(n, b // n, *x.shape[1:])
    return cm.tree_map(split, batch, _is_leaf)


def _value_and_grad(model, params, batch):
    """(loss, metrics, grads): ``model.loss`` on leaves that require grad
    (views of ``params``' tensors), its gradient in the tree's layout."""
    leaves = {p: t.detach().requires_grad_(True) for p, t in
              cm.tree_leaves_with_path(params, torch.is_tensor)}
    tree = cm.tree_map_with_path(lambda p, _: leaves[p], params,
                                 torch.is_tensor)
    with torch.enable_grad():
        loss, metrics = model.loss(tree, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    by_path = dict(zip(leaves, grads))
    grads = cm.tree_map_with_path(lambda p, _: by_path[p], params,
                                  torch.is_tensor)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(model, opt_config: OptConfig, grad_accum: int = 1):
    device = model.device

    def step(state: TrainState, batch):
        state = TrainState(*on_device(tuple(state), device))
        batch = on_device(batch, device)
        if grad_accum == 1:
            loss, metrics, grads = _value_and_grad(model, state.params, batch)
        else:
            micro = _split_microbatches(batch, grad_accum)
            grads = cm.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device),
                state.params, torch.is_tensor)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(grad_accum):
                mb = cm.tree_map(lambda x: x[i], micro, torch.is_tensor)
                l, _, g = _value_and_grad(model, state.params, mb)
                g_of = dict(cm.tree_leaves_with_path(g, torch.is_tensor))
                grads = cm.tree_map_with_path(
                    lambda p, s: torch.add(s, g_of[p]), grads,
                    torch.is_tensor)
                loss = loss + l
            grads = cm.tree_map(lambda g: g / grad_accum, grads,
                                torch.is_tensor)
            loss = loss / grad_accum
            metrics = {}

        new_params, new_opt, opt_metrics = apply_updates(
            state.params, grads, state.opt, opt_config,
            getattr(model, "shardings", None))
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params=new_params, opt=new_opt), metrics

    return step


def make_eval_step(model):
    def step(params, batch):
        params = on_device(params, model.device)
        with torch.no_grad():
            loss, metrics = model.loss(params, on_device(batch, model.device))
        return {"loss": loss, **metrics}
    return step
