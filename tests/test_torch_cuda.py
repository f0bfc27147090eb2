"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a CUDA device (the kernels have
no CPU mode).  This file imports no JAX, so it also runs on a machine
with only the port's dependencies::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import solve  # noqa: E402
from repro_torch.connectivity import minmap  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs.oracle import connected_components_oracle  # noqa: E402
from repro_torch.kernels import contour_mm  # noqa: E402
from repro_torch.kernels.contour_mm import blocked, kernel  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _states(g, count=3):
    L = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    out = [L]
    for _ in range(count):
        L = minmap.pointer_jump(minmap.mm_relax(L, g.src, g.dst, 2))
        out.append(L)
    return out


@pytest.mark.parametrize("graph", ["rmat", "grid", "star"])
def test_kernels_match_plain(cuda, graph):
    g = {"rmat": lambda: gen.rmat(14, seed=7, device=cuda),
         "grid": lambda: gen.grid2d(100, 120, device=cuda),
         "star": lambda: gen.star(5000, seed=1, device=cuda)}[graph]()
    contour_mm.reset_launch_counts()
    gen_ = torch.Generator(device=cuda).manual_seed(0)
    for L in _states(g):
        for limit in (None, 0, g.n_edges // 2):
            assert torch.equal(
                blocked.fused_relax(L, g.src, g.dst, edge_limit=limit),
                blocked.fused_relax_plain(L, g.src, g.dst, limit))
        for order in (1, 2, 3):
            t, v = minmap.mm_update_stream(L, g.src, g.dst, order)
            valid = torch.rand(t.shape, device=cuda, generator=gen_) < 0.5
            for vd in (None, valid):
                assert torch.equal(blocked.scatter_min(L, t, v, vd),
                                   blocked.scatter_min_plain(L, t, v, vd))
    torch.cuda.synchronize()
    # edge_limit=0 launches nothing
    assert blocked.fused_relax.launches == 4 * 2
    assert blocked.scatter_min.launches == 4 * 6


def test_solve_on_the_card_launches_the_kernels(cuda):
    g = gen.components_mix([gen.path(3000, seed=1, device="cpu"),
                            gen.rmat(12, seed=2, device="cpu")], seed=3,
                           device=cuda)
    want = connected_components_oracle(*g.to_numpy())
    for variant, kernel in (("C-2", blocked.fused_relax),
                            ("C-11mm", blocked.scatter_min)):
        contour_mm.reset_launch_counts()
        res = solve(g, variant=variant)
        assert kernel.launches > 0
        plain = solve(g, variant=variant, backend="torch")
        for field in ("labels", "iterations", "converged", "edges_visited"):
            assert torch.equal(getattr(res, field), getattr(plain, field))
        assert res.labels.device.type == "cuda"
        assert (res.labels.cpu().numpy() == want).all()


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    L = torch.arange(8, dtype=torch.int32, device=cuda)
    e = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        blocked.fused_relax(L.long(), e, e)
    with pytest.raises(ValueError):
        blocked.fused_relax(L, e.cpu(), e)
    with pytest.raises(ValueError):
        blocked.scatter_min(L, e, e, valid=torch.ones(2, dtype=torch.bool))


def test_kernels_reject_out_of_range_ids_on_the_card(cuda):
    def i32(*ids):
        return torch.tensor(ids, dtype=torch.int32, device=cuda)

    L = torch.arange(8, dtype=torch.int32, device=cuda)
    bad_label = L.clone()
    bad_label[3] = 9
    # (kernel call with an id outside [0, 8), what it gives once the bad
    # edge or update is skipped)
    cases = [
        (lambda c: blocked.fused_relax(L, i32(0, 8), i32(1, 2), check=c),
         [0, 0, 2, 3, 4, 5, 6, 7]),
        (lambda c: blocked.fused_relax(L, i32(1), i32(-1), check=c),
         list(range(8))),
        (lambda c: blocked.fused_relax(bad_label, i32(3, 4), i32(2, 1),
                                       check=c),
         [0, 1, 2, 9, 1, 5, 6, 7]),
        (lambda c: blocked.scatter_min(L, i32(1, 8), i32(0, 0), check=c),
         [0, 0, 2, 3, 4, 5, 6, 7]),
        (lambda c: blocked.scatter_min(L, i32(-1, 5), i32(0, 2), check=c),
         [0, 1, 2, 3, 4, 2, 6, 7]),
    ]
    for call, skipped in cases:
        with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
            call(True)
        # unchecked, the kernel still touches nothing outside L
        assert call(False).tolist() == skipped
    torch.cuda.synchronize()


@pytest.mark.parametrize("graph", ["rmat", "grid", "path"])
def test_mm2_matches_plain(cuda, graph):
    g = {"rmat": lambda: gen.rmat(12, seed=7, device=cuda),
         "grid": lambda: gen.grid2d(60, 70, device=cuda),
         "path": lambda: gen.path(5000, seed=2, device=cuda)}[graph]()
    contour_mm.reset_launch_counts()
    for L in _states(g, count=2):
        for limit in (None, 0, g.n_edges // 3):
            assert torch.equal(
                kernel.mm2(L, g.src, g.dst, edge_limit=limit),
                kernel.mm2_plain(L.cpu(), g.src.cpu(), g.dst.cpu(),
                                 limit).to(cuda))
    torch.cuda.synchronize()
    # edge_limit=0 launches nothing
    assert kernel.mm2.launches == 3 * 2


def test_mm2_rejects_out_of_range_ids_on_the_card(cuda):
    def i32(*ids):
        return torch.tensor(ids, dtype=torch.int32, device=cuda)

    L = torch.arange(8, dtype=torch.int32, device=cuda)
    cases = [
        (lambda c: kernel.mm2(L, i32(0, 8), i32(1, 2), check=c),
         [0, 0, 2, 3, 4, 5, 6, 7]),
        (lambda c: kernel.mm2(L, i32(1, 5), i32(-1, 2), check=c),
         [0, 1, 2, 3, 4, 2, 6, 7]),
        (lambda c: kernel.mm2(i32(0, 1, 3, -1, 4, 5, 6, 7), i32(2, 2),
                              i32(2, 2), check=c),
         [0, 1, -1, -1, 4, 5, 6, 7]),
    ]
    for call, skipped in cases:
        with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
            call(True)
        # unchecked, the kernel still touches nothing outside L
        assert call(False).tolist() == skipped
    torch.cuda.synchronize()


@pytest.mark.parametrize("options", [
    {"variant": "C-2"}, {"variant": "C-Syn"},
    {"variant": "C-2", "sampling": 2, "compact_every": 2},
    {"variant": "C-m", "sampling": 2, "compact_every": 1,
     "sampling_strategy": "kout"},
])
def test_solve_cuda_async_on_the_card_matches_cpu(cuda, options):
    g = gen.components_mix([gen.path(3000, seed=1, device="cpu"),
                            gen.rmat(12, seed=2, device="cpu")], seed=3,
                           device="cpu")
    contour_mm.reset_launch_counts()
    on_card = gen.Graph.from_numpy(*g.to_numpy(), device=cuda)
    res = solve(on_card, backend="cuda_async", **options)
    assert kernel.mm2.launches > 0
    on_cpu = solve(g, backend="cuda_async", **options)
    for field in ("labels", "iterations", "converged", "edges_visited"):
        assert torch.equal(getattr(res, field).cpu(), getattr(on_cpu, field))
    want = connected_components_oracle(*g.to_numpy())
    assert (res.labels.cpu().numpy() == want).all()


@pytest.mark.parametrize("strategy", ["prefix", "kout", "bfs"])
def test_frontier_on_the_card_matches_the_torch_backend(cuda, strategy):
    g = gen.components_mix([gen.rmat(13, seed=4, device="cpu"),
                            gen.grid2d(100, 120, device="cpu")], seed=5,
                           device=cuda)
    assert g.n_edges >= 1 << 15          # the staged schedule
    contour_mm.reset_launch_counts()
    res = solve(g, sampling=2, compact_every=2, sampling_strategy=strategy)
    assert blocked.fused_relax.launches > 0
    plain = solve(g, sampling=2, compact_every=2, sampling_strategy=strategy,
                  backend="torch")
    for field in ("labels", "iterations", "converged", "edges_visited"):
        assert torch.equal(getattr(res, field), getattr(plain, field))
    assert "schedule=staged" in res.provenance[0]
