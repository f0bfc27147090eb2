"""The port's architecture registry and parameter specs against the JAX
package's: all ten ``ARCHS`` field by field (dtypes compared by name),
``smoke_config()``, ``cells()``, ``input_specs`` for every shape, the
ten configs' ``param_specs()`` (paths, shapes, logical axes, init,
scale; the encoder-decoder's ``embed``/``encoder``/``decoder`` tree) and ``resolve_spec`` over them on a ``(data, model)`` and a
``(pod, data, model)`` mesh under every profile.  Pure Python: exact
equality."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import input_specs as ref_input_specs  # noqa: E402
from repro.jax_compat import abstract_mesh  # noqa: E402
from repro.models import common as ref_cm  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.model import lm_param_specs  # noqa: E402
from repro_torch.runtime import Mesh  # noqa: E402

DECODERS = ("olmo-1b", "stablelm-1.6b", "mistral-nemo-12b", "yi-6b",
            "llava-next-34b")
MESHES = {"data_model": ((16, 16), ("data", "model")),
          "pod_data_model": ((2, 16, 16), ("pod", "data", "model"))}


def dtype_name(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return np.dtype(d).name


def same_value(a, b) -> bool:
    if isinstance(b, torch.dtype):
        return dtype_name(a) == dtype_name(b)
    return a == b


def assert_same_config(ref, port):
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for name in names:
        a, b = getattr(ref, name), getattr(port, name)
        assert same_value(a, b), (ref.name, name, a, b)
    assert ref.hd == port.hd and ref.padded_vocab == port.padded_vocab
    assert ref.seq_parallel == port.seq_parallel


def ref_leaves(tree):
    """(dotted path, leaf) of a reference pytree, in its own order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, ref_cm.ParamSpec))
    return [(".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path), leaf) for path, leaf in flat]


def test_the_registry_has_the_reference_names():
    assert list(ARCHS) == list(REF_ARCHS)
    assert list(SHAPES) == list(REF_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.astuple(shape) == \
            dataclasses.astuple(REF_SHAPES[name])
    with pytest.raises(KeyError):
        get_arch("gpt-5")


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_arch_equals_the_reference(name):
    ref, port = REF_ARCHS[name], ARCHS[name]
    assert_same_config(ref.config, port.config)
    for field in ("source", "grad_accum", "grad_accum_multipod",
                  "src_frames", "smoke_overrides"):
        assert getattr(ref, field) == getattr(port, field)
    assert port.accum_for(True) == ref.accum_for(True)
    assert port.accum_for(False) == ref.accum_for(False)
    assert_same_config(ref.smoke_config(), port.smoke_config())
    assert_same_config(ref.config.for_serving(), port.config.for_serving())
    assert ref.cells() == port.cells()
    for shape in REF_SHAPES:
        assert ref.skip_reason(shape) == port.skip_reason(shape)
        want = ref_input_specs(ref, shape)
        got = input_specs(port, shape)
        assert sorted(want) == sorted(got)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape), (shape, key)
            assert dtype_name(got[key].dtype) == dtype_name(spec.dtype)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_param_specs_equal_the_reference(name, smoke):
    ref_arch, arch = REF_ARCHS[name], ARCHS[name]
    ref_config = ref_arch.smoke_config() if smoke else ref_arch.config
    config = arch.smoke_config() if smoke else arch.config
    want = ref_leaves(ref_build(ref_config).param_specs())
    got = cm.tree_leaves_with_path(lm_param_specs(config), cm.is_spec)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert (a.shape, a.logical_axes, a.init, a.scale) == \
            (b.shape, b.logical_axes, b.init, b.scale), path


def test_mistral_nemo_12b_counts_the_published_parameters():
    specs = lm_param_specs(ARCHS["mistral-nemo-12b"].config)
    n = sum(int(np.prod(s.shape)) for _, s in
            cm.tree_leaves_with_path(specs, cm.is_spec))
    assert n == 12_247_782_400
    assert ARCHS["mistral-nemo-12b"].config.hd == 128   # not 5120 / 32


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("profile", sorted(ref_cm.PROFILES))
def test_resolve_spec_equals_the_reference(profile, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_mesh = abstract_mesh(shape, axes)
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes,
                device="cpu")
    assert cm.PROFILES[profile] == ref_cm.PROFILES[profile]
    for name in DECODERS:
        for shard_cache_seq in (False, True):
            ref_config = REF_ARCHS[name].config.replace(
                sharding_profile=profile, shard_cache_seq=shard_cache_seq)
            config = ARCHS[name].config.replace(
                sharding_profile=profile, shard_cache_seq=shard_cache_seq)
            ref_rules = ref_cm.make_rules(ref_config, ref_mesh)
            rules = cm.make_rules(config, mesh)
            assert rules == ref_rules
            leaves = ref_leaves(ref_build(ref_config).param_specs())
            # and a KV cache's axes, where kv_seq and kv_heads compete
            leaves.append(("cache", ref_cm.ParamSpec(
                (128, 32768, config.n_kv_heads, config.hd),
                ("batch", "kv_seq", "kv_heads", None))))
            for path, spec in leaves:
                want = ref_cm.resolve_spec(spec.shape, spec.logical_axes,
                                           ref_mesh, ref_rules)
                got = cm.resolve_spec(spec.shape, spec.logical_axes, mesh,
                                      rules)
                assert got == tuple(want), (name, path)


def test_resolve_spec_rejects_a_rank_mismatch():
    mesh = Mesh(np.arange(4).reshape(2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        cm.resolve_spec((4, 4), ("embed",), mesh, cm.DEFAULT_RULES)


def test_abstract_and_logical_trees():
    config = ARCHS["yi-6b"].smoke_config()
    specs = lm_param_specs(config)
    abstract = cm.abstract_tree(specs, config.param_dtype)
    axes = cm.logical_axes_tree(specs)
    for (path, spec), (p2, t), (p3, ax) in zip(
            cm.tree_leaves_with_path(specs, cm.is_spec),
            cm.tree_leaves_with_path(abstract, torch.is_tensor),
            cm.tree_leaves_with_path(axes, lambda x: isinstance(x, tuple))):
        assert path == p2 == p3
        assert t.device.type == "meta" and t.dtype == torch.float32
        assert tuple(t.shape) == spec.shape and ax == spec.logical_axes
