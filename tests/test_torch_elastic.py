"""The port's elastic mesh, its ``Mesh`` and the resilient distributed
solve on one rank, against the JAX package's.

``repro_torch.runtime.derive_mesh_shape`` is held to the reference's on
``tests/test_elastic.py``'s cases; ``elastic_mesh`` and ``Mesh`` (groups,
shard order, ranks outside the mesh, refusals) are checked on their own;
and ``resilient_distributed_contour`` on a 1-rank mesh is held to the
reference's on a 1-device mesh on ``tests/test_chaos.py``'s single-device
cases (a restart from the manager's checkpoint, the straggler ladder, a
budget that runs out): the same labels, counters, stats and events.
These run in this process under a gloo world of one rank that a fixture
makes and destroys; the 8-rank shrink is in ``test_torch_distributed.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import jax  # noqa: E402

import repro  # noqa: E402
from repro.checkpoint.manager import \
    CheckpointManager as RefManager  # noqa: E402
from repro.connectivity import resilience as ref_resilience  # noqa: E402
from repro.connectivity.distributed import \
    distributed_contour as ref_distributed  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402
from repro.runtime import elastic as ref_elastic  # noqa: E402
from repro.runtime.recovery import FaultInjector as RefInjector  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.connectivity import (FaultInjector,  # noqa: E402
                                      SolveOptions,
                                      resilient_distributed_contour)
from repro_torch.connectivity.distributed import \
    distributed_contour  # noqa: E402
from repro_torch.runtime import Mesh, derive_mesh_shape  # noqa: E402
from repro_torch.runtime import elastic_mesh  # noqa: E402
from repro_torch.runtime.mesh import group_of  # noqa: E402

CPU = "cpu"

SHAPES = [
    # (n_devices, model_parallel, prefer_pods) -> the reference's tests'
    ((4, 4, 1), (1, 4)), ((16, 16, 1), (1, 16)), ((31, 16, 1), (1, 16)),
    ((4, 4, 2), (1, 4)), ((512, 16, 3), (2, 16, 16)), ((40, 4, 4), (2, 5, 4)),
    ((7, 1, 4), (7, 1)), ((12, 2, 6), (6, 1, 2)), ((8, 1, 1), (8, 1)),
    ((6, 1, 1), (6, 1)),
]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of one rank in this process, destroyed afterwards."""
    store = tmp_path_factory.mktemp("elastic_world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("args,want", SHAPES, ids=[str(a) for a, _ in SHAPES])
def test_derive_mesh_shape_matches_the_reference(args, want):
    assert derive_mesh_shape(*args) == ref_elastic.derive_mesh_shape(*args) \
        == want


@pytest.mark.parametrize("args", [(3, 4), (0, 1)])
def test_derive_mesh_shape_raises_when_the_model_axis_does_not_fit(args):
    with pytest.raises(ValueError, match="model_parallel"):
        ref_elastic.derive_mesh_shape(*args)
    with pytest.raises(ValueError, match="model_parallel"):
        derive_mesh_shape(*args)


def test_shrink_sequence_monotone():
    for n in range(16, 3, -1):
        shape = derive_mesh_shape(n, 4)
        assert shape == ref_elastic.derive_mesh_shape(n, 4)
        assert int(np.prod(shape)) <= n and shape[-1] == 4


def test_elastic_mesh_on_one_rank_runs_the_distributed_solve(world1):
    """The smallest elastic mesh (the shrink's terminal state) is a mesh
    the distributed solver takes, with the reference's axes and result."""
    mesh = elastic_mesh(1, device=CPU)
    ref_mesh = ref_elastic.elastic_mesh(1, jax.devices())
    assert mesh.axis_names == ref_mesh.axis_names == ("data", "model")
    assert tuple(mesh.devices.shape) == tuple(ref_mesh.devices.shape)
    assert mesh.coordinate == (0, 0) and mesh.device == torch.device(CPU)
    g = ref_gen.components_mix([ref_gen.path(200, seed=1),
                                ref_gen.rmat(8, seed=2)], seed=3)
    s, d, n = g.to_numpy()
    ref = ref_distributed(g, ref_mesh, edge_axes=("data",))
    port = distributed_contour(interop.graph_from_arrays(s, d, n, device=CPU),
                               mesh, edge_axes=("data",))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(port[0].numpy(),
                                  connected_components_oracle(s, d, n))
    assert int(port[1]) == int(ref[1]) and bool(port[2]) and bool(ref[2])
    assert (port[3].numpy().view(np.uint32)
            == np.asarray(ref[3]).view(np.uint32))


def test_elastic_mesh_too_few_devices_raises():
    with pytest.raises(ValueError, match="model_parallel"):
        elastic_mesh(3, [0, 1], device=CPU)


@pytest.mark.parametrize("devices,mp,pods", [(range(3), 2, 1),
                                             (range(7), 2, 3),
                                             (range(5), 1, 2)])
def test_elastic_mesh_discards_surplus_ranks(devices, mp, pods):
    mesh = elastic_mesh(mp, devices, pods, device=CPU)
    shape = derive_mesh_shape(len(devices), mp, pods)
    assert tuple(mesh.devices.shape) == shape
    used = int(np.prod(shape))
    np.testing.assert_array_equal(mesh.devices.reshape(-1),
                                  np.arange(used))
    for rank in list(devices)[used:]:
        assert mesh.coordinate_of(rank) is None


def test_mesh_groups_and_shard_order():
    """The ranks of a collective over some axes share the others'
    coordinates; a block's index takes the first named axis as major."""
    mesh = Mesh(np.arange(8).reshape(2, 4), ("pod", "data"), device=CPU)
    assert mesh.shape == {"pod": 2, "data": 4}
    assert mesh.n_shards(("pod", "data")) == 8
    for rank in range(8):
        assert mesh.group_ranks(("pod", "data"), rank) == tuple(range(8))
        assert mesh.shard_index(("pod", "data"), rank) == rank
    assert mesh.group_ranks(("data",), 5) == (4, 5, 6, 7)
    assert mesh.shard_index(("data",), 5) == 1
    assert mesh.group_ranks(("pod",), 6) == (2, 6)
    assert mesh.group_ranks(("data", "pod"), 5) == (0, 4, 1, 5, 2, 6, 3, 7)
    assert mesh.shard_index(("data", "pod"), 5) == 3
    dm = Mesh(np.arange(8).reshape(4, 2), ("data", "model"), device=CPU)
    assert dm.group_ranks(("data",), 3) == (1, 3, 5, 7)
    assert dm.shard_index(("data",), 3) == 1
    assert dm.n_shards(("data",)) == 4


def test_mesh_refusals():
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.arange(4), ("data", "model"), device=CPU)
    with pytest.raises(ValueError, match="distinct ranks"):
        Mesh(np.array([0, 0]), ("data",), device=CPU)
    with pytest.raises(ValueError, match="distinct"):
        Mesh(np.arange(4).reshape(2, 2), ("data", "data"), device=CPU)
    with pytest.raises(TypeError, match="integer ranks"):
        Mesh(np.array([0.0]), ("data",), device=CPU)
    mesh = Mesh(np.arange(4), ("data",), device=CPU)
    with pytest.raises(ValueError, match="axes"):
        mesh.group_ranks(("model",), 0)
    with pytest.raises(ValueError, match="not in"):
        mesh.shard_index(("data",), 9)


def test_mesh_takes_no_cpu_on_its_own():
    """Without CUDA and without a named device a mesh raises; it does not
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default device is a CUDA one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh(np.arange(2), ("data",))


def test_a_group_over_the_whole_world_is_the_default_group(world1):
    assert group_of([0]) is None
    mesh = Mesh(np.array([[0]]), ("data", "model"), device=CPU)
    assert mesh.group(("data",)) is None


# -- the resilient solve on one rank, against the reference's ----------------


def _graph():
    g = ref_gen.components_mix([ref_gen.path(300, seed=1),
                                ref_gen.rmat(9, seed=2)], seed=3)
    s, d, n = g.to_numpy()
    return g, interop.graph_from_arrays(s, d, n, device=CPU), \
        connected_components_oracle(s, d, n)


class _ScriptedMonitor:
    """StragglerMonitor stand-in returning a scripted action sequence."""

    def __init__(self, actions):
        self.actions = list(actions)

    def start_step(self):
        pass

    def end_step(self):
        return self.actions.pop(0)


def _same_result(ref, port):
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.converged) == bool(ref.converged)
    assert (port.edges_visited.numpy().view(np.uint32)
            == np.asarray(ref.edges_visited).view(np.uint32))
    assert port.provenance[1:] == ref.provenance[1:]


def _both(tmp_path, backend, **kw):
    """Both packages' resilient solve with the same faults and monitor
    script; returns their (result, stats) pairs and the oracle."""
    ref_g, g, oracle = _graph()
    fail_at = kw.pop("fail_at", ())
    script = kw.pop("script", None)
    use_manager = kw.pop("manager", False)
    ref = ref_resilience.resilient_distributed_contour(
        ref_g, options=repro.SolveOptions(backend="xla", **kw.get("opts", {})),
        block_rounds=kw.get("block_rounds", 2),
        fault_injector=RefInjector(fail_at=fail_at) if fail_at else None,
        manager=(RefManager(str(tmp_path / "ref"), async_save=False)
                 if use_manager else None),
        straggler=_ScriptedMonitor(script) if script else None)
    port = resilient_distributed_contour(
        g, options=SolveOptions(backend=backend, **kw.get("opts", {})),
        block_rounds=kw.get("block_rounds", 2),
        fault_injector=FaultInjector(fail_at=fail_at) if fail_at else None,
        manager=(CheckpointManager(str(tmp_path / "port"), async_save=False)
                 if use_manager else None),
        straggler=_ScriptedMonitor(script) if script else None, device=CPU)
    return ref, port, oracle


@pytest.mark.chaos
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_resilient_restart_from_the_manager(world1, tmp_path, backend):
    """A plain fault on a 1-rank mesh: a warm restart from the manager's
    last checkpoint, the reference's fixed point and stats."""
    (ref, ref_stats), (port, stats), oracle = _both(
        tmp_path, backend, fail_at=((1, "round"),), manager=True)
    _same_result(ref, port)
    assert dict(stats) == dict(ref_stats)
    assert stats.restarts == 1 and stats.shrinks == 0
    np.testing.assert_array_equal(port.labels.numpy(), oracle)
    assert CheckpointManager(str(tmp_path / "port")).latest_step() \
        == RefManager(str(tmp_path / "ref")).latest_step()


@pytest.mark.chaos
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_resilient_straggler_ladder(world1, tmp_path, backend):
    """"checkpoint" then "evict": both force a snapshot; one rank cannot
    shrink below the model-parallel floor, so the solve goes on."""
    (ref, ref_stats), (port, stats), oracle = _both(
        tmp_path, backend, script=["checkpoint", "evict"] + ["ok"] * 50,
        manager=True, block_rounds=4)
    _same_result(ref, port)
    assert dict(stats) == dict(ref_stats)
    assert stats.shrinks == 0 and stats.checkpoints >= 2
    assert ("straggler_checkpoint", 0) in stats.events


@pytest.mark.chaos
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_resilient_budget_runs_out(world1, tmp_path, backend):
    """A budget of one round reports converged=False, and the partial
    labels are a sound warm start."""
    (ref, ref_stats), (port, stats), oracle = _both(
        tmp_path, backend, opts={"max_iters": 1}, block_rounds=1)
    _same_result(ref, port)
    assert dict(stats) == dict(ref_stats)
    assert not bool(port.converged)
    again = repro_torch.solve(_graph()[1], backend=backend, warm_start=port)
    np.testing.assert_array_equal(again.labels.numpy(), oracle)


def test_resilient_options_match_the_reference_signature():
    import inspect
    ref = inspect.signature(ref_resilience.resilient_distributed_contour)
    port = inspect.signature(resilient_distributed_contour)
    # the port adds the rank's device; every reference parameter is there
    assert list(ref.parameters) == [p for p in port.parameters
                                    if p != "device"]
