"""Train steps of the decoder archs' smoke configs against the JAX
package's ``make_train_step``, in float32 compute, from one carried-across
state (the other five archs: ``tests/test_torch_train_families.py``,
which imports :func:`check_train_step` from here); the tolerances and
why each is needed are in ``tests/test_torch_train_step.py``'s docstring
(its helpers are used here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim.adamw import OptConfig as RefOptConfig  # noqa: E402
from repro.train.step import make_train_step as ref_make  # noqa: E402

from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402

from test_torch_train_step import (CPU, GRAD_TOL, OPT, PARAM_ATOL,  # noqa: E402
                                   PARAM_RTOL, batches, check_drops,
                                   close_leaves, numpy_tree, port_batch,
                                   ref_batch, start)


DECODERS = ("llava-next-34b", "mistral-nemo-12b", "olmo-1b", "stablelm-1.6b",
            "yi-6b")


def check_train_step(name: str) -> None:
    """Two steps of every arch's smoke config in float32: the first
    step's gradients, both losses and grad norms, every parameter and
    first moment after the second (the MoE archs' drops token for token
    first)."""
    ref_config, config, state, port = start(name)
    model = build_model(config, device=CPU)
    data = batches(config, 2)
    if config.n_experts:
        check_drops(ref_config, model, port, data[0])
    ref_model = ref_build(ref_config)
    ref_step = ref_make(ref_model, RefOptConfig(**OPT))

    def grads_and_step(s, b):      # one program: XLA shares the gradient
        _, g = jax.value_and_grad(ref_model.loss, has_aux=True)(s.params, b)
        return g, ref_step(s, b)

    ref_run = jax.jit(grads_and_step)
    step = make_train_step(model, OptConfig(**OPT))
    for i, batch in enumerate(data):
        ref_grads, (state, want) = ref_run(state, ref_batch(batch))
        if i == 0:
            _, _, grads = _value_and_grad(model, port.params,
                                          port_batch(batch))
            close_leaves(numpy_tree(ref_grads), grads, GRAD_TOL["float32"],
                         scaled=True)
        port, got = step(port, port_batch(batch))
        assert set(got) == set(want) == {"ce", "aux", "lr", "grad_norm",
                                         "loss"}
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(want["grad_norm"]),
                                   rtol=1e-4 if i == 0 else 5e-3)
        assert float(got["lr"]) == float(want["lr"])
    assert int(port.opt["step"]) == int(state.opt["step"]) == 2
    close_leaves(numpy_tree(state.params), port.params, PARAM_ATOL,
                 PARAM_RTOL)
    close_leaves(numpy_tree(state.opt["m"]), port.opt["m"], PARAM_ATOL,
                 PARAM_RTOL)


@pytest.mark.parametrize("name", DECODERS)
def test_train_step_matches_the_reference(name):
    check_train_step(name)
