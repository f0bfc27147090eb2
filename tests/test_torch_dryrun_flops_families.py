"""Product FLOPs of the other five archs' smoke programs on ``meta``
against the reference's compiled CPU programs (the helpers of
``tests/test_torch_dryrun_flops.py``), and the one deliberate deviation
(ROADMAP Queue C): a train step of the recurrent archs (xlstm-125m,
zamba2-2.7b) counts fewer products than the reference's.

Why: a recurrence's state enters with zeros and leaves unused by the
loss.  The reference runs it in a ``lax.scan``, whose transpose computes
every carry's cotangent on every trip, and XLA keeps those products:
the state update's backward on the final state's zero cotangent (two
products) and the first chunk's state gradient (one), while it drops
the dead forward update where the loop has one trip (XLA removes such a
loop, then its dead code).  The port runs eagerly: autograd computes no
gradient that no leaf needs, and the forward computes the final state
(it is returned).  So on the smoke shapes (one chunk of ``gla_chunked``)
the reference counts one state-update product (2·B·H·N·P·c) more a
``gla_chunked`` call (Mamba2, mLSTM), and, a sLSTM layer, the first
step's recurrent product towards the zero initial state
(2·B·G·H·hd·hd); on several chunks it counts three state-update
products more a call.  The tests hold the gaps to exactly those sums,
with no tolerance; every other cell is equal.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as ref_ssm  # noqa: E402
from repro.roofline.hlo_cost import analyze_text  # noqa: E402

from repro_torch.models import ssm  # noqa: E402
from repro_torch.roofline.op_cost import price  # noqa: E402

from test_torch_dryrun_flops import (KINDS, check_equal,  # noqa: E402
                                     port_cost, reference_flops)

FAMILIES = ("arctic-480b", "deepseek-moe-16b", "seamless-m4t-large-v2",
            "xlstm-125m", "zamba2-2.7b")
RECURRENT = ("xlstm-125m", "zamba2-2.7b")


def _cases():
    for name in FAMILIES:
        for kind in KINDS:
            if not (kind == "train" and name in RECURRENT):
                yield name, kind


@pytest.mark.parametrize("name,kind", list(_cases()))
def test_product_flops_equal_the_references(name, kind):
    check_equal(name, kind)


def _state_products(monkeypatch) -> list:
    """Record, for each ``gla_chunked`` call and each sLSTM layer (its
    ``slstm_init_state``), the product the reference counts more (see
    the module's docstring)."""
    products = []
    gla, init = ssm.gla_chunked, ssm.slstm_init_state

    def gla_recorded(q, k, v, log_f, *, chunk=128, s0=None):
        b, t, h, n = q.shape
        c = min(chunk, t)
        if t % c:
            c = math.gcd(t, c)
        assert c == t                      # one chunk at the smoke shapes
        products.append(2 * b * h * n * v.shape[-1] * c)
        return gla(q, k, v, log_f, chunk=chunk, s0=s0)

    def init_recorded(batch, config, device=None):
        h, hd = ssm.slstm_dims(config)
        products.append(2 * batch * 4 * h * hd * hd)     # 4 gates
        return init(batch, config, device)

    monkeypatch.setattr(ssm, "gla_chunked", gla_recorded)
    monkeypatch.setattr(ssm, "slstm_init_state", init_recorded)
    return products


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_train_steps_differ_by_the_final_states_products(
        name, monkeypatch):
    products = _state_products(monkeypatch)
    got = port_cost(name, "train").flops
    assert products
    assert reference_flops(name, "train") - got == sum(products)


@pytest.mark.parametrize("t,more", [(16, 1), (48, 3)],
                         ids=["one-chunk", "three-chunks"])
def test_gla_alone_differs_by_its_state_products(t, more):
    """``gla_chunked``'s loss and gradient, its final state unused: the
    reference counts ``more`` state-update products (2·B·H·N·P·c) than
    the port, c = 16."""
    b, h, n, p, chunk = 2, 3, 8, 5, 16

    def ref_loss(q, k, v, f):
        return jnp.sum(ref_ssm.gla_chunked(q, k, v, f, chunk=chunk)[0])

    sds = jax.ShapeDtypeStruct
    shapes = (sds((b, t, h, n), jnp.float32), sds((b, t, h, n), jnp.float32),
              sds((b, t, h, p), jnp.float32), sds((b, t, h), jnp.float32))
    program = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1, 2, 3)))
    want = analyze_text(program.lower(*shapes).compile().as_text()).flops

    def port_loss_and_grad(q, k, v, f):
        leaves = [x.requires_grad_(True) for x in (q, k, v, f)]
        loss = ssm.gla_chunked(*leaves, chunk=chunk)[0].sum()
        return loss, torch.autograd.grad(loss, leaves)

    args = [torch.empty(s.shape, device="meta") for s in shapes]
    got = price(port_loss_and_grad, *args)[1].flops
    assert want - got == more * 2 * b * h * n * p * chunk
