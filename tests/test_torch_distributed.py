"""The port's distributed Contour against the JAX package's, bit for bit.

The reference runs once, in one subprocess that sees 8 CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` does), over every case below on its
8-device meshes, and saves each case's results to an npz.  The port runs
the same cases in one ``torch.multiprocessing`` spawn of 8 gloo ranks
(one process a rank, a FileStore under the test's temporary directory),
on CPU tensors, through the ``cuda`` backend (the kernels' plain
versions here) and the ``torch`` backend; every rank saves what it
returned.  Each case is then a test: labels, rounds, ``converged`` and
the float32 ``edges_visited`` by their bits, on every rank alike.

Cases: ``path(3000)``, ``grid2d(40, 40)``, ``rmat(11)`` and a components
mix, at ``local_rounds`` 1 and 3, on the dense schedule and the frontier
(``(sampling, compact_every)`` in (2, 2), (0, 1), (3, 0)); a warm start;
``n_active`` on a graph padded with self-loops; ``max_iters=1`` (the
dense branch ends with no final jump); a ``(2, 4)`` ``("pod", "data")``
mesh over both axes and a ``(4, 2)`` ``("data", "model")`` mesh over
``data``; ``solve(g, SolveOptions(mesh=...))``;
``distributed_contour_step_fn`` with ``check_every`` 1 and 3; the
elastic shrink 8 -> 7 -> 6 (``resilient_distributed_contour``: its
``mesh_history``, events, provenance and labels, and the shed ranks'
marks); and the stream's mesh path (``state_dict()`` after every
batch).  ``edges_visited`` stays below 2**24 in every case, so the
float32 sums are exact whatever order gloo adds the ranks' bounds in.

A rank that stops while the others go on leaves them waiting in a
collective: ``test_a_rank_that_stops_early_fails_its_peers`` shows the
spawn failing, not finishing.  1-rank cases run in this process under a
gloo world of one that a fixture makes and destroys.  Every spawn and
subprocess has its own timeout, so a hung rank fails its tests and does
not hold the suite.
"""
import datetime
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import jax  # noqa: E402

import repro  # noqa: E402
from repro import jax_compat  # noqa: E402
from repro.connectivity.distributed import \
    distributed_contour as ref_distributed  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.oracle import connected_components_oracle  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.connectivity import distributed  # noqa: E402
from repro_torch.runtime import Mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SPAWN_TIMEOUT_S = 240
REFERENCE_TIMEOUT_S = 400
PORT_BACKENDS = ("cuda", "torch")
SCHEDULES = ((0, 0), (2, 2), (0, 1), (3, 0))
GRAPH_NAMES = ("path", "grid", "rmat", "mix")
STREAM_BATCHES = 6


def _graph_arrays():
    """The cases' graphs as numpy (src, dst, n), and the warm start."""
    graphs = {
        "path": ref_gen.path(3000, seed=1),
        "grid": ref_gen.grid2d(40, 40),
        "rmat": ref_gen.rmat(11, seed=2),
        "mix": ref_gen.components_mix(
            [ref_gen.path(500, seed=3), ref_gen.star(400, seed=4)], seed=5),
    }
    out = {name: g.to_numpy() for name, g in graphs.items()}
    s, d, n = out["mix"]
    pad = np.zeros(37, np.int32)
    out["mix_padded"] = (np.concatenate([s, pad]), np.concatenate([d, pad]),
                         n)
    s, d, n = out["path"]
    half = repro.solve(repro.Graph.from_numpy(s[: len(s) // 2],
                                              d[: len(d) // 2], n),
                       backend="xla", max_iters=2)
    return out, {"path_half": np.asarray(half.labels)}


def _cases():
    """Every spawned case, as JSON-able dicts."""
    cases = []

    def add(cid, **kw):
        case = dict(id=cid, kind="contour", mesh=[[WORLD], ["data"]],
                    edge_axes=["data"], local_rounds=1, sampling=0,
                    compact_every=0, max_iters=10_000, init=None,
                    n_active=None)
        case.update(kw)
        cases.append(case)

    for g in GRAPH_NAMES:
        for lr in (1, 3):
            for s, ce in SCHEDULES:
                add(f"{g}-lr{lr}-s{s}c{ce}", graph=g, local_rounds=lr,
                    sampling=s, compact_every=ce)
    for s, ce in ((0, 0), (2, 2)):
        add(f"warm-s{s}c{ce}", graph="path", init="path_half", sampling=s,
            compact_every=ce)
    for s, ce in ((0, 0), (0, 1)):
        add(f"n_active-s{s}c{ce}", graph="mix_padded", n_active="real",
            sampling=s, compact_every=ce)
    for s, ce in ((0, 0), (2, 2)):
        add(f"max_iters1-s{s}c{ce}", graph="rmat", max_iters=1, sampling=s,
            compact_every=ce)
    add("pod_data-dense", graph="rmat", mesh=[[2, 4], ["pod", "data"]],
        edge_axes=["pod", "data"])
    add("pod_data-s2c2", graph="grid", mesh=[[2, 4], ["pod", "data"]],
        edge_axes=["pod", "data"], sampling=2, compact_every=2,
        local_rounds=3)
    add("data_model-dense", graph="path", mesh=[[4, 2], ["data", "model"]])
    add("data_model-s0c1", graph="rmat", mesh=[[4, 2], ["data", "model"]],
        compact_every=1)
    add("solve-dense", kind="solve", graph="mix")
    add("solve-lr3-s2c2", kind="solve", graph="rmat", local_rounds=3,
        sampling=2, compact_every=2)
    for every in (1, 3):
        add(f"step-check{every}", kind="step", graph="path", check_every=every)
    add("stream", kind="stream", graph="rmat")
    add("shrink", kind="shrink", graph="mix")
    add("restart", kind="restart", graph="mix")
    add("straggler", kind="straggler", graph="mix")
    return cases


CASES = _cases()
RESILIENT = ("shrink", "restart", "straggler")
PORT_IDS = [f"{c['id']}-{b}" for c in CASES for b in PORT_BACKENDS
            if c["kind"] not in ("stream",) + RESILIENT]


def _stream_batches(src, dst):
    perm = np.random.default_rng(0).permutation(len(src))
    src, dst = src[perm], dst[perm]
    m = len(src)
    return [(src[b * m // STREAM_BATCHES:(b + 1) * m // STREAM_BATCHES],
             dst[b * m // STREAM_BATCHES:(b + 1) * m // STREAM_BATCHES])
            for b in range(STREAM_BATCHES)]


class ScriptedMonitor:
    """StragglerMonitor stand-in returning a scripted action sequence."""

    def __init__(self, actions):
        self.actions = list(actions)

    def start_step(self):
        pass

    def end_step(self):
        return self.actions.pop(0)


def _resilient_args(kind, rank, injector, shard_loss, manager, ckpt):
    """The resilient cases' faults: ``shrink`` loses a rank at round
    blocks 1 and 2 (8 -> 7 -> 6); ``restart`` fails block 1 plainly and
    restarts from the checkpoint that the mesh's first rank wrote at block
    0 (forced by the monitor); ``straggler`` has only the last rank
    recommend an eviction at block 0, which every rank then acts on."""
    if kind == "shrink":
        return {"fault_injector": injector(
            fail_at=((1, "round"), (2, "round")),
            exc_factory=lambda step, site: shard_loss(1))}
    if kind == "restart":
        return {"fault_injector": injector(fail_at=((1, "round"),)),
                "manager": manager(ckpt, async_save=False),
                "straggler": ScriptedMonitor(["checkpoint"] + ["ok"] * 50)}
    script = ["evict" if rank == WORLD - 1 else "ok"] + ["ok"] * 50
    return {"straggler": ScriptedMonitor(script)}


def _n_active(case, graphs):
    if case["n_active"] == "real":
        return len(graphs["mix"][0])
    return case["n_active"]


def _save(path, out: dict) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _load(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# the reference: one subprocess with 8 CPU devices
# ---------------------------------------------------------------------------


def reference_main(inputs: str, out_file: str) -> None:
    """Run every case on the reference's 8-device meshes (in a process
    that sees 8 CPU devices) and save the results."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.connectivity import (FaultInjector, SolveOptions,
                                    StreamingConnectivity,
                                    resilient_distributed_contour)
    from repro.checkpoint.manager import CheckpointManager as RefManager
    from repro.connectivity.distributed import distributed_contour_step_fn
    from repro.runtime.recovery import ShardLossFault

    assert len(jax.devices()) == WORLD, jax.devices()
    arrays = _load(inputs)
    graphs = {k[:-4]: (arrays[k[:-4] + "/src"], arrays[k[:-4] + "/dst"],
                       int(arrays[k[:-4] + "/n"]))
              for k in arrays if k.endswith("/src")}
    results = {}
    for case in CASES:
        cid = case["id"]
        src, dst, n = graphs[case["graph"]]
        g = repro.Graph.from_numpy(src, dst, n)
        shape, names = case["mesh"]
        mesh = jax_compat.make_mesh(tuple(shape), tuple(names))
        axes = tuple(case["edge_axes"])
        init = (None if case["init"] is None
                else jax.numpy.asarray(arrays["init/" + case["init"]]))
        if case["kind"] == "contour":
            out = ref_distributed(
                g, mesh, edge_axes=axes, local_rounds=case["local_rounds"],
                max_iters=case["max_iters"], backend="xla",
                init_labels=init, sampling=case["sampling"],
                compact_every=case["compact_every"],
                n_active=_n_active(case, graphs))
        elif case["kind"] == "solve":
            res = repro.solve(g, SolveOptions(
                mesh=mesh, backend="xla", local_rounds=case["local_rounds"],
                sampling=case["sampling"],
                compact_every=case["compact_every"]))
            out = (res.labels, res.iterations, res.converged,
                   res.edges_visited)
        elif case["kind"] == "step":
            pad = (-len(src)) % WORLD
            spec = NamedSharding(mesh, P("data"))
            s = jax.device_put(np.concatenate([src, np.zeros(pad, np.int32)]),
                               spec)
            d = jax.device_put(np.concatenate([dst, np.zeros(pad, np.int32)]),
                               spec)
            out = distributed_contour_step_fn(
                s, d, n, mesh, ("data",), case["local_rounds"],
                case["max_iters"], case["check_every"], "xla")
        elif case["kind"] == "stream":
            eng = StreamingConnectivity(n, SolveOptions(mesh=mesh,
                                                        backend="xla"))
            for b, (bs, bd) in enumerate(_stream_batches(src, dst)):
                eng.ingest(bs, bd)
                for key, value in eng.state_dict().items():
                    results[f"{cid}|b{b}|{key}"] = np.asarray(value)
            continue
        else:
            res, stats = resilient_distributed_contour(
                g, devices=jax.devices(), options=SolveOptions(backend="xla"),
                block_rounds=2,
                **_resilient_args(case["kind"], WORLD - 1, FaultInjector,
                                  ShardLossFault, RefManager,
                                  os.path.join(os.path.dirname(out_file),
                                               "ref_ckpt")))
            out = (res.labels, res.iterations, res.converged,
                   res.edges_visited)
            results[f"{cid}|provenance"] = np.asarray(
                json.dumps(list(res.provenance)))
            results[f"{cid}|stats"] = np.asarray(json.dumps(stats))
        for field, value in zip(("labels", "iterations", "converged",
                                 "edges_visited"), out):
            results[f"{cid}|{field}"] = np.asarray(value)
    _save(out_file, results)


_REFERENCE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {tests!r})
    import test_torch_distributed as t
    t.reference_main({inputs!r}, {out_file!r})
""")


# ---------------------------------------------------------------------------
# the port: one rank a process
# ---------------------------------------------------------------------------


def _init_rank(rank: int, world: int, store: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def _run_case(case, backend, graphs, arrays, results, rank,
              out_dir) -> None:
    from repro_torch.connectivity import (FaultInjector, SolveOptions,
                                          StreamingConnectivity,
                                          resilient_distributed_contour)
    from repro_torch.runtime import ShardLossFault

    cid = f"{case['id']}-{backend}"
    src, dst, n = graphs[case["graph"]]
    g = interop.graph_from_arrays(src, dst, n, device="cpu")
    shape, names = case["mesh"]
    mesh = Mesh(np.arange(WORLD).reshape(shape), names, device="cpu")
    axes = tuple(case["edge_axes"])
    init = (None if case["init"] is None
            else torch.from_numpy(arrays["init/" + case["init"]]))
    if case["kind"] == "contour":
        out = distributed.distributed_contour(
            g, mesh, edge_axes=axes, local_rounds=case["local_rounds"],
            max_iters=case["max_iters"], backend=backend, init_labels=init,
            sampling=case["sampling"], compact_every=case["compact_every"],
            n_active=_n_active(case, graphs))
    elif case["kind"] == "solve":
        res = repro_torch.solve(g, SolveOptions(
            mesh=mesh, backend=backend, local_rounds=case["local_rounds"],
            sampling=case["sampling"], compact_every=case["compact_every"]))
        out = (res.labels, res.iterations, res.converged, res.edges_visited)
    elif case["kind"] == "step":
        s, d, _ = distributed.shard_block(g.src, g.dst, mesh, ("data",))
        out = distributed.distributed_contour_step_fn(
            s, d, n, mesh, ("data",), case["local_rounds"],
            case["max_iters"], case["check_every"], backend)
    elif case["kind"] == "stream":
        eng = StreamingConnectivity(n, SolveOptions(mesh=mesh,
                                                    backend=backend))
        for b, (bs, bd) in enumerate(_stream_batches(src, dst)):
            eng.ingest(bs, bd)
            for key, value in eng.state_dict().items():
                results[f"{cid}|b{b}|{key}"] = _host(value)
        return
    else:
        from repro_torch.checkpoint import CheckpointManager
        res, stats = resilient_distributed_contour(
            g, devices=range(WORLD), options=SolveOptions(backend=backend),
            block_rounds=2, device="cpu",
            **_resilient_args(case["kind"], rank, FaultInjector,
                              ShardLossFault, CheckpointManager,
                              os.path.join(out_dir, f"ckpt-{backend}")))
        out = (res.labels, res.iterations, res.converged, res.edges_visited)
        results[f"{cid}|provenance"] = json.dumps(list(res.provenance))
        results[f"{cid}|stats"] = json.dumps(stats)
    for field, value in zip(("labels", "iterations", "converged",
                             "edges_visited"), out):
        results[f"{cid}|{field}"] = value.numpy()


def _host(value):
    return value.numpy() if isinstance(value, torch.Tensor) else value


def _rank_main(rank: int, world: int, store: str, job: dict) -> None:
    """One rank of a spawn: ``job["kind"]`` is ``"cases"`` (every case on
    both backends, saved to ``rank<r>.npz``) or ``"early_stop"`` (the last
    rank leaves after one round)."""
    if job["kind"] == "early_stop":
        _init_rank(rank, world, store, timeout_s=5)
        g = interop.graph_from_arrays(
            *ref_gen.path(300, seed=1).to_numpy(), device="cpu")
        mesh = Mesh(np.arange(world), ("data",), device="cpu")
        distributed.distributed_contour(
            g, mesh, max_iters=1 if rank == world - 1 else 10_000)
        dist.destroy_process_group()
        return
    _init_rank(rank, world, store, timeout_s=120)
    arrays = _load(job["inputs"])
    graphs = {k[:-4]: (arrays[k[:-4] + "/src"], arrays[k[:-4] + "/dst"],
                       int(arrays[k[:-4] + "/n"]))
              for k in arrays if k.endswith("/src")}
    results = {}
    for case in CASES:
        for backend in PORT_BACKENDS:
            _run_case(case, backend, graphs, arrays, results, rank,
                      job["out"])
    _save(os.path.join(job["out"], f"rank{rank}.npz"), results)
    dist.destroy_process_group()


def spawn(world: int, store: str, job: dict, timeout_s: float) -> None:
    """``world`` ranks of ``_rank_main``; raises if one fails or the
    spawn outlives ``timeout_s`` (the ranks are then killed)."""
    ctx = mp.start_processes(_rank_main, args=(world, store, job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, each rank's results, the graphs)."""
    tmp = tmp_path_factory.mktemp("distributed")
    graphs, warm = _graph_arrays()
    arrays = {}
    for name, (s, d, n) in graphs.items():
        arrays.update({f"{name}/src": s, f"{name}/dst": d, f"{name}/n": n})
    arrays.update({f"init/{k}": v for k, v in warm.items()})
    inputs = str(tmp / "inputs.npz")
    _save(inputs, arrays)
    env = dict(os.environ, XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={WORLD}"),
        PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                    os.environ.get("PYTHONPATH", "")]))
    ref_out = str(tmp / "reference.npz")
    code = _REFERENCE.format(tests=str(ROOT / "tests"), inputs=inputs,
                             out_file=ref_out)
    with subprocess.Popen([sys.executable, "-c", code], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True) as reference:
        try:
            spawn(WORLD, str(tmp / "store"),
                  {"kind": "cases", "inputs": inputs, "out": str(tmp)},
                  SPAWN_TIMEOUT_S)
            _, err = reference.communicate(timeout=REFERENCE_TIMEOUT_S)
        finally:
            if reference.poll() is None:
                reference.kill()
    assert reference.returncode == 0, err[-3000:]
    ranks = [_load(tmp / f"rank{r}.npz") for r in range(WORLD)]
    return _load(ref_out), ranks, graphs


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of one rank in this process, destroyed afterwards."""
    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield Mesh(np.array([0]), ("data",), device="cpu")
    dist.destroy_process_group()


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _same(ref: dict, port: dict, ref_key: str, port_key: str, field: str):
    a, b = ref[f"{ref_key}|{field}"], port[f"{port_key}|{field}"]
    assert a.dtype == b.dtype and a.shape == b.shape, (field, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=field)


# ---------------------------------------------------------------------------
# the spawned cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port_id", PORT_IDS)
def test_case_matches_the_reference_on_8_ranks(runs, port_id):
    ref, ranks, graphs = runs
    cid, _ = port_id.rsplit("-", 1)
    case = next(c for c in CASES if c["id"] == cid)
    fields = (("labels", "iterations") if case["kind"] == "step" else
              ("labels", "iterations", "converged", "edges_visited"))
    for field in fields:
        _same(ref, ranks[0], cid, port_id, field)
    if "edges_visited" in fields:
        # exact float32 sums in any order of the ranks' bounds
        assert float(ref[f"{cid}|edges_visited"]) < 2 ** 24
    if case["max_iters"] > 1:
        s, d, n = graphs[case["graph"]]
        np.testing.assert_array_equal(ranks[0][f"{port_id}|labels"],
                                      connected_components_oracle(s, d, n))


def test_max_iters_one_ends_with_no_final_jump(runs):
    """A budget of one round stops before the fixed point, with the
    labels of that round as they are (the dense branch takes no final
    pointer jump): not yet a star forest on rmat(11)."""
    _, ranks, _ = runs
    for backend in PORT_BACKENDS:
        labels = ranks[0][f"max_iters1-s0c0-{backend}|labels"]
        assert not ranks[0][f"max_iters1-s0c0-{backend}|converged"]
        assert (labels[labels] != labels).any()


@pytest.mark.parametrize("rank", range(1, WORLD))
def test_every_rank_returns_the_same(runs, rank):
    """The labels are replicated and the loop's words agreed: every rank
    ends with rank 0's result (the shed ranks of the shrink excepted)."""
    _, ranks, _ = runs
    for key, value in ranks[0].items():
        if (key.startswith("shrink-") and rank >= WORLD - 2
                or key.startswith("straggler-") and rank == WORLD - 1):
            continue
        np.testing.assert_array_equal(_bits(ranks[rank][key]), _bits(value),
                                      err_msg=key)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_stream_mesh_path_matches_the_reference(runs, backend):
    """``StreamingConnectivity(n, SolveOptions(mesh=...))``: the whole
    ``state_dict()`` after every batch."""
    ref, ranks, _ = runs
    keys = sorted(k for k in ref if k.startswith("stream|"))
    assert len({k.split("|")[1] for k in keys}) == STREAM_BATCHES
    for key in keys:
        a = ref[key]
        b = ranks[0][key.replace("stream|", f"stream-{backend}|", 1)]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=key)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_elastic_shrink_8_7_6_matches_the_reference(runs, backend):
    """Shard loss at round blocks 1 and 2: the mesh shrinks 8 -> 7 -> 6
    (``mesh_history``), warm-resumes and converges to the reference's
    labels, with its provenance and events; ranks 7 and 6 leave at the
    blocks that shed them."""
    ref, ranks, graphs = runs
    port_id = f"shrink-{backend}"
    for field in ("labels", "iterations", "converged", "edges_visited"):
        _same(ref, ranks[0], "shrink", port_id, field)
    want = json.loads(str(ref["shrink|stats"]))
    got = json.loads(str(ranks[0][f"{port_id}|stats"]))
    assert got == want
    assert got["mesh_history"] == [[8, 1], [7, 1], [6, 1]]
    ref_prov = json.loads(str(ref["shrink|provenance"]))
    prov = json.loads(str(ranks[0][f"{port_id}|provenance"]))
    assert prov[1:] == ref_prov[1:] == ["elastic_shrink:8->7",
                                        "elastic_shrink:7->6"]
    assert prov[0].startswith(f"plan:{backend}")
    s, d, n = graphs["mix"]
    np.testing.assert_array_equal(ranks[0][f"{port_id}|labels"],
                                  connected_components_oracle(s, d, n))
    for rank, block in ((WORLD - 1, 1), (WORLD - 2, 2)):
        shed = json.loads(str(ranks[rank][f"{port_id}|stats"]))
        assert shed["shed"] == block
        assert not ranks[rank][f"{port_id}|converged"]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("kind", ["restart", "straggler"])
def test_resilient_spmd_rules_match_the_reference(runs, kind, backend):
    """The SPMD rules of the resilient solve on 8 ranks: a restart reads
    the checkpoint only the mesh's first rank wrote (after a barrier), and
    one rank's eviction is every rank's; both end on the reference's
    labels, counters, stats and provenance."""
    ref, ranks, graphs = runs
    port_id = f"{kind}-{backend}"
    for field in ("labels", "iterations", "converged", "edges_visited"):
        _same(ref, ranks[0], kind, port_id, field)
    got = json.loads(str(ranks[0][f"{port_id}|stats"]))
    assert got == json.loads(str(ref[f"{kind}|stats"]))
    prov = json.loads(str(ranks[0][f"{port_id}|provenance"]))
    assert prov[1:] == json.loads(str(ref[f"{kind}|provenance"]))[1:]
    s, d, n = graphs["mix"]
    np.testing.assert_array_equal(ranks[0][f"{port_id}|labels"],
                                  connected_components_oracle(s, d, n))
    if kind == "restart":
        assert got["restarts"] == 1 and got["checkpoints"] >= 2
        assert ("restart", 1) in [tuple(e) for e in got["events"]]
    else:
        assert got["mesh_history"] == [[8, 1], [7, 1]]
        assert prov[1:] == ["straggler_evict:8->7"]
        shed = json.loads(str(ranks[WORLD - 1][f"{port_id}|stats"]))
        assert shed["shed"] == 1


def test_a_rank_that_stops_early_fails_its_peers(tmp_path):
    """Every rank must issue the same collectives: when the last rank
    leaves after one round, the others' next all-reduce fails (gloo's
    timeout is 5 s here) instead of the spawn finishing."""
    with pytest.raises(Exception) as info:
        spawn(2, str(tmp_path / "store"), {"kind": "early_stop"}, 60)
    assert not isinstance(info.value, TimeoutError), info.value


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------


def _ref_mesh1():
    return jax_compat.device_mesh(np.array(jax.devices()[:1]), ("data",))


def _pair(g):
    s, d, n = g.to_numpy()
    return g, interop.graph_from_arrays(s, d, n, device="cpu")


CONFORMANCE_GRAPHS = {
    "path": lambda: ref_gen.path(120, seed=3),
    "mix": lambda: ref_gen.components_mix(
        [ref_gen.path(40, seed=1), ref_gen.star(30, seed=2),
         ref_gen.grid2d(6, 6)], seed=4),
    "rmat": lambda: ref_gen.rmat(8, seed=5),
}


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("gname", sorted(CONFORMANCE_GRAPHS))
def test_conformance_row_on_one_rank(world1, gname, backend):
    """The reference's conformance row ``algorithm="distributed"`` on a
    1-device mesh, against the port's 1-rank mesh."""
    ref_g, g = _pair(CONFORMANCE_GRAPHS[gname]())
    ref = repro.solve(ref_g, repro.SolveOptions(algorithm="distributed",
                                                mesh=_ref_mesh1()))
    port = repro_torch.solve(g, repro_torch.SolveOptions(
        algorithm="distributed", mesh=world1, backend=backend))
    np.testing.assert_array_equal(port.labels.numpy(),
                                  np.asarray(ref.labels))
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.converged) == bool(ref.converged)
    assert _bits(port.edges_visited.numpy()) == _bits(ref.edges_visited)


def test_solve_routes_a_mesh_to_distributed(world1):
    ref_g, g = _pair(CONFORMANCE_GRAPHS["mix"]())
    res = repro_torch.solve(g, mesh=world1)
    ref = repro.solve(ref_g, repro.SolveOptions(mesh=_ref_mesh1()))
    assert res.provenance[0].startswith("plan:cuda")
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))
    assert int(res.iterations) == int(ref.iterations)
    # the single-device C-2 loop ends with a final jump; the mesh's does
    # not, and its round is not C-2's schedule
    alias = repro_torch.solve(g, algorithm="contour_distributed", mesh=world1,
                              backend="torch")
    assert int(alias.iterations) == int(ref.iterations)


def test_mesh_refusals_match_the_reference(world1):
    ref_g, g = _pair(CONFORMANCE_GRAPHS["path"]())
    graphs = [ref_gen.path(20, seed=0), ref_gen.path(30, seed=1)]
    port_graphs = [_pair(x)[1] for x in graphs]
    for run, mesh, gr, gs in (
            (repro, _ref_mesh1(), ref_g, graphs),
            (repro_torch, world1, g, port_graphs)):
        with pytest.raises(ValueError, match="mesh"):
            run.solve(gr, algorithm="distributed")
        with pytest.raises(ValueError, match="does not run on a mesh"):
            run.solve(gr, algorithm="fastsv", mesh=mesh)
        with pytest.raises(ValueError, match="single-device only"):
            run.solve(gr, mesh=mesh, sampling=2, sampling_strategy="kout")
        with pytest.raises(ValueError, match="mesh"):
            run.solve_batch(gs, mesh=mesh)
        with pytest.raises(ValueError, match="batched"):
            run.solve_batch(gs, algorithm="distributed")
        with pytest.raises(ValueError, match="edge_axes"):
            run.solve(gr, mesh=mesh, edge_axes=())
    with pytest.raises(TypeError, match="Mesh"):
        repro_torch.solve(g, mesh=_ref_mesh1())


def test_registry_entry_matches_the_reference():
    import dataclasses
    from repro.connectivity import registry as ref_registry
    from repro_torch.connectivity import registry
    port = dataclasses.asdict(registry.get_solver("distributed"))
    ref = dataclasses.asdict(ref_registry.get_solver("distributed"))
    for key in ("fn",):
        port.pop(key)
        ref.pop(key)
    assert port == ref
    assert registry.get_solver("contour_distributed").name == "distributed"
    assert registry.get_solver("contour").supports_mesh


def test_warm_start_on_one_rank(world1):
    src, dst, n = ref_gen.rmat(9, seed=11).to_numpy()
    cut = len(src) // 2
    warm = connected_components_oracle(src[:cut], dst[:cut], n)
    ref = repro.solve(repro.Graph.from_numpy(src, dst, n),
                      repro.SolveOptions(mesh=_ref_mesh1()), warm_start=warm)
    port = repro_torch.solve(
        interop.graph_from_arrays(src, dst, n, device="cpu"), mesh=world1,
        warm_start=torch.from_numpy(warm.astype(np.int32)))
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.iterations) == int(ref.iterations)


def test_stream_on_a_one_rank_mesh(world1):
    """The stream's mesh path on one rank: the reference's state after
    every batch, and the padding of each batch's bucket never counted."""
    from test_torch_streaming import same_state
    src, dst, n = ref_gen.components_mix(
        [ref_gen.path(300, seed=1), ref_gen.rmat(9, seed=2)],
        seed=3).to_numpy()
    ref = repro.StreamingConnectivity(
        n, repro.SolveOptions(mesh=_ref_mesh1(), backend="xla"))
    port = repro_torch.StreamingConnectivity(n, mesh=world1)
    assert port.device == torch.device("cpu")
    for bs, bd in _stream_batches(src, dst):
        ref.ingest(bs, bd)
        port.ingest(bs, bd)
        same_state(ref, port)
    # 3 real edges in a bucket of 64: only the real ones are counted
    ref4 = repro.StreamingConnectivity(4, repro.SolveOptions(
        mesh=_ref_mesh1()))
    port4 = repro_torch.StreamingConnectivity(4, mesh=world1)
    for eng in (ref4, port4):
        eng.ingest(np.array([0, 1, 2]), np.array([1, 2, 3]))
    same_state(ref4, port4)


def test_a_rank_outside_the_mesh_is_refused(world1):
    g = _pair(CONFORMANCE_GRAPHS["path"]())[1]
    outside = Mesh(np.array([1]), ("data",), device="cpu")
    with pytest.raises(ValueError, match="not in"):
        distributed.distributed_contour(g, outside)
