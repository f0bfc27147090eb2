"""The port's sharding rules against the JAX package's, on the abstract
production meshes (no ranks, no process group).

The reference's ``tests/test_sharding.py`` cases on the port, then every
parameter leaf's resolved spec (``shardings_for``) and every cache leaf's
(``cache_shardings`` zipped with ``init_cache``'s shapes, at two shapes)
of the ten archs, training and ``for_serving()`` configs, on both
production meshes, against the reference's.  The port's cache is made
on the ``meta`` device; its ``length`` is a Python int where the
reference's is an array (both replicated).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.jax_compat import abstract_mesh  # noqa: E402
from repro.models import common as ref_cm  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import PROFILES, ModelConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.mesh import AbstractMesh  # noqa: E402

ARCH_NAMES = sorted(ARCHS)
CACHE_SHAPES = ((2, 64), (32, 4096))


def mesh_single():
    return make_production_mesh()


def mesh_multi():
    return make_production_mesh(multi_pod=True)


def _cfg(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=2048,
                n_heads=32, n_kv_heads=8, d_ff=5632, vocab_size=100352)
    base.update(kw)
    return ModelConfig(**base)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_sharding.py), on the port
# ---------------------------------------------------------------------------

def test_production_meshes():
    single, multi = mesh_single(), mesh_multi()
    assert isinstance(single, AbstractMesh)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")


def test_host_mesh_refuses_an_indivisible_world():
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        make_host_mesh(2, devices=[0, 1, 2], device="cpu")
    mesh = make_host_mesh(2, devices=[0, 1, 2, 3], device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices.tolist() == [[0, 1], [2, 3]]


def test_resolve_divisible_axis():
    cfg = _cfg(sharding_profile="tp")
    rules = cm.make_rules(cfg, mesh_single())
    assert cm.resolve_spec((2048, 5632), (None, "ffn"), mesh_single(),
                           rules) == (None, "model")


def test_resolve_indivisible_falls_back_to_replication():
    cfg = _cfg(sharding_profile="tp")
    rules = cm.make_rules(cfg, mesh_single())
    assert cm.resolve_spec((2048, 8, 128), (None, "kv_heads", None),
                           mesh_single(), rules) == ()


def test_batch_flat_profile_uses_all_axes():
    cfg = _cfg(sharding_profile="fsdp")
    rules = cm.make_rules(cfg, mesh_multi())
    assert cm.resolve_spec((512, 4096), ("batch", None), mesh_multi(),
                           rules) == (("pod", "data", "model"),)
    assert cm.resolve_spec((64, 4096), ("batch", None), mesh_multi(),
                           rules) == (("pod", "data"),)


def test_used_axis_exclusivity_kv_cache():
    cfg = _cfg(shard_cache_seq=True)
    rules = cm.make_rules(cfg, mesh_single())
    assert cm.resolve_spec((128, 32768, 8, 128),
                           ("batch", "kv_seq", "kv_heads", None),
                           mesh_single(), rules) == ("data", "model")
    cfg2 = _cfg(shard_cache_seq=False, n_kv_heads=32)
    rules2 = cm.make_rules(cfg2, mesh_single())
    assert cm.resolve_spec((128, 32768, 32, 128),
                           ("batch", "kv_seq", "kv_heads", None),
                           mesh_single(), rules2) == ("data", None, "model")


def test_seq_parallel_profile():
    cfg = _cfg(sharding_profile="tp_sp")
    assert cfg.seq_parallel
    rules = cm.make_rules(cfg, mesh_single())
    assert cm.resolve_spec((256, 4096, 2048), ("batch", "seq", "embed"),
                           mesh_single(), rules) == ("data", "model")


def test_every_profile_has_all_logical_axes():
    names = set(PROFILES["tp"])
    for pname, rules in PROFILES.items():
        assert set(rules) == names, pname


def test_param_shardings_cover_whole_tree():
    for arch_name in ("yi-6b", "deepseek-moe-16b", "zamba2-2.7b"):
        cfg = get_arch(arch_name).config
        specs = build_model(cfg, device="meta").param_specs()
        shardings = cm.shardings_for(specs, cfg, mesh_single())
        n1 = len(cm.tree_leaves_with_path(specs, cm.is_spec))
        n2 = len(cm.tree_leaves_with_path(
            shardings, lambda x: isinstance(x, cm.Sharding)))
        assert n1 == n2 > 10


def test_expert_weights_sharded_on_model():
    mesh = mesh_single()
    cfg = get_arch("deepseek-moe-16b").config
    assert cm.resolve_spec((64, 2048, 1408),
                           ("experts", None, "expert_inner"), mesh,
                           cm.make_rules(cfg, mesh)) == ("model",)
    cfg2 = get_arch("arctic-480b").config
    assert cm.resolve_spec((128, 7168, 4864),
                           ("experts", None, "expert_inner"), mesh,
                           cm.make_rules(cfg2, mesh)) == ("model", None,
                                                          "data")


def test_cache_axes_structure_matches_cache():
    cfg = get_arch("zamba2-2.7b").smoke_config()
    model = build_model(cfg, device="meta")
    shapes = model.init_cache(2, 64)
    out = tfm.resolve_cache_shardings(
        tfm.cache_shardings(cfg, mesh_single(), model.plan), shapes)
    got = [p for p, _ in cm.tree_leaves_with_path(
        out, lambda x: isinstance(x, cm.Sharding))]
    want = [p for p, _ in cm.tree_leaves_with_path(
        shapes, lambda x: isinstance(x, (torch.Tensor, int)))]
    assert got == want


def test_abstract_and_concrete_params_agree():
    cfg = get_arch("stablelm-1.6b").smoke_config()
    model = build_model(cfg, device="cpu")
    abstract = cm.abstract_tree(model.param_specs(), cfg.param_dtype)
    concrete = model.init(torch.Generator().manual_seed(0))

    def kinds(tree):
        return [(p, tuple(t.shape), t.dtype) for p, t in
                cm.tree_leaves_with_path(tree, torch.is_tensor)]

    assert kinds(abstract) == kinds(concrete)


def test_shard_shape_divides_by_the_spec():
    sh = cm.Sharding(mesh_multi(), (("pod", "data"), "model"))
    assert sh.shard_shape((64, 32, 5)) == (2, 2, 5)
    assert sh.layout(3) == (("pod", "data"), ("model",), ())


# ---------------------------------------------------------------------------
# every leaf of the ten archs against the reference
# ---------------------------------------------------------------------------

def _meshes(multi: bool):
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi else \
        ((16, 16), ("data", "model"))
    return make_production_mesh(multi_pod=multi), abstract_mesh(shape, names)


def _configs(name: str, serving: bool):
    ref, port = ref_get_arch(name).config, get_arch(name).config
    if serving:
        ref, port = ref.for_serving(), port.for_serving()
    return ref, port


def _ref_specs(tree):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


def _port_specs(tree):
    return [s.spec for _, s in cm.tree_leaves_with_path(
        tree, lambda x: isinstance(x, cm.Sharding))]


def test_every_arch_is_covered():
    assert sorted(REF_ARCHS) == ARCH_NAMES


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_the_reference(name, serving, multi):
    mesh, ref_mesh = _meshes(multi)
    ref_config, config = _configs(name, serving)
    want = _ref_specs(ref_cm.shardings_for(
        ref_build(ref_config).param_specs(), ref_config, ref_mesh))
    got = _port_specs(cm.shardings_for(
        build_model(config, device="meta").param_specs(), config, mesh))
    assert got == want


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_specs_match_the_reference(name, serving, multi):
    mesh, ref_mesh = _meshes(multi)
    ref_config, config = _configs(name, serving)
    ref_model = ref_build(ref_config)
    model = build_model(config, device="meta")
    ref_plan = getattr(ref_model, "dec_plan", None) or ref_model.plan
    plan = getattr(model, "dec_plan", None) or model.plan
    for batch, max_len in CACHE_SHAPES:
        shapes = jax.eval_shape(lambda: ref_model.init_cache(batch, max_len))
        want = _ref_specs(ref_tfm.resolve_cache_shardings(
            ref_tfm.cache_shardings(ref_config, ref_mesh, ref_plan), shapes))
        cache = model.init_cache(batch, max_len)
        got = _port_specs(tfm.resolve_cache_shardings(
            tfm.cache_shardings(config, mesh, plan), cache))
        assert got == want, (batch, max_len)
