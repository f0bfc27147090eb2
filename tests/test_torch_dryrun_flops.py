"""Product FLOPs of the port's programs on ``meta`` tensors (no mesh,
``roofline.op_cost``) against ``repro.roofline.hlo_cost.analyze_text`` of
the reference's compiled CPU program, for the smoke configs' train step
(``make_train_step``), prefill and decode: equal at 1e-6 (they are equal
exactly).  The decoder archs here; the other five in
``tests/test_torch_dryrun_flops_families.py`` (which imports the
helpers), where the recurrent archs' train steps differ by a pinned
deviation (ROADMAP Queue C).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import common as ref_cm  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim.adamw import OptConfig as RefOptConfig  # noqa: E402
from repro.roofline.hlo_cost import analyze_text  # noqa: E402
from repro.train.step import TrainState as RefTrainState  # noqa: E402
from repro.train.step import make_train_step as ref_make  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.roofline.op_cost import price  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import TrainState  # noqa: E402

B, T = 2, 16
KINDS = ("train", "prefill", "decode")
DECODERS = ("llava-next-34b", "mistral-nemo-12b", "olmo-1b", "stablelm-1.6b",
            "yi-6b")


def _batch(config, kind: str, make) -> dict:
    out = {"tokens": make((B, T), "int32")}
    if kind == "train":
        out["labels"] = make((B, T), "int32")
    if config.frontend == "patch_stub":
        out["patch_embeds"] = make((B, config.n_frontend_tokens,
                                    config.d_model), config.dtype)
    if config.frontend == "audio_stub":
        frames = T // 2 if kind == "train" else T
        out["frame_embeds"] = make((B, frames, config.d_model), config.dtype)
    return out


def _init_cache(model, config):
    if config.family == "audio":
        return model.init_cache(B, T, src_len=T)
    return model.init_cache(B, T)


def reference_flops(name: str, kind: str) -> float:
    """``analyze_text`` of the reference's compiled CPU program."""
    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(
            shape, jnp.int32 if dtype == "int32" else dtype)

    config = ref_get_arch(name).smoke_config()
    if kind != "train":
        config = config.for_serving()
    model = ref_build(config)
    params = ref_cm.abstract_tree(model.param_specs(), config.param_dtype)
    batch = _batch(config, kind, sds)
    if kind == "train":
        state = RefTrainState(params=params, opt={
            "m": params, "v": params,
            "step": jax.ShapeDtypeStruct((), jnp.int32)})
        lowered = jax.jit(ref_make(model, RefOptConfig())).lower(state, batch)
    elif kind == "prefill":
        lowered = jax.jit(lambda p, b: model.prefill(p, b)).lower(
            params, batch)
    else:
        cache = jax.eval_shape(lambda: _init_cache(model, config))
        lowered = jax.jit(lambda p, t, c: model.decode_step(p, t, c)).lower(
            params, sds((B, 1), "int32"), cache)
    return analyze_text(lowered.compile().as_text()).flops


def port_cost(name: str, kind: str):
    """The port's program of the same cell on ``meta`` tensors."""
    def meta(shape, dtype):
        dtype = torch.int32 if dtype == "int32" else dtype
        return torch.empty(shape, dtype=dtype, device="meta")

    config = get_arch(name).smoke_config()
    if kind != "train":
        config = config.for_serving()
    model = build_model(config, device="meta")
    params = model.params()
    batch = _batch(config, kind, meta)
    if kind == "train":
        opt = OptConfig()
        state = TrainState(params, init_opt_state(params, opt))
        return price(make_train_step(model, opt), state, batch)[1]
    if kind == "prefill":
        return price(model.prefill, params, batch)[1]
    return price(model.decode_step, params, meta((B, 1), "int32"),
                 _init_cache(model, config))[1]


def check_equal(name: str, kind: str) -> None:
    want = reference_flops(name, kind)
    got = port_cost(name, kind).flops
    assert want > 0
    assert got == pytest.approx(want, rel=1e-6), (got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", DECODERS)
def test_product_flops_equal_the_references(name, kind):
    check_equal(name, kind)
