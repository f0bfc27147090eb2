"""The plain reference against a brute-force search, on the CPU."""
from collections import deque

import pytest

torch = pytest.importorskip("torch")

from portbench import controls, graphs, reference  # noqa: E402


def bfs_labels(src, dst, n, pick=min):
    adj = [[] for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].append(b)
        adj[b].append(a)
    comp = [-1] * n
    for v in range(n):
        if comp[v] >= 0:
            continue
        members, queue = [v], deque([v])
        comp[v] = v
        while queue:
            u = queue.popleft()
            for w in adj[u]:
                if comp[w] < 0:
                    comp[w] = v
                    members.append(w)
                    queue.append(w)
        label = pick(members)
        for w in members:
            comp[w] = label
    return torch.tensor(comp, dtype=torch.int32)


def random_forest_graph(n, m, seed):
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (m,), generator=g, dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=g, dtype=torch.int32)
    return src, dst, n


def shuffled_path(n, seed):
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    return perm[:-1].int(), perm[1:].int(), n


CASES = {
    "kronecker": lambda: graphs.kronecker(
        9, 16, 0.57, 0.19, 0.19, 0.05, torch.Generator().manual_seed(1)),
    "rgg": lambda: graphs.rgg(10, 0.55, torch.Generator().manual_seed(2)),
    "sparse_random": lambda: random_forest_graph(700, 400, 3),
    "shuffled_path": lambda: shuffled_path(1500, 4),
    "no_edges": lambda: (torch.zeros(0, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.int32), 9),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("block", [7, 1 << 27])
def test_reference_equals_bfs(case, block):
    src, dst, n = CASES[case]()
    expected = bfs_labels(src, dst, n)
    got = reference.components(src, dst, n, block=block)
    assert got.dtype == torch.int32
    assert reference.mismatches(got, expected) == 0


@pytest.mark.parametrize("case", ["kronecker", "sparse_random"])
def test_greatest_id_control_is_the_same_partition(case):
    src, dst, n = CASES[case]()
    got = controls.greatest_id_labels(src, dst, n)
    assert torch.equal(got, bfs_labels(src, dst, n, pick=max))
    assert reference.mismatches(got, reference.components(src, dst, n)) > 0


def test_mismatches_counts_a_wrong_shape_as_all_wrong():
    a = torch.arange(5, dtype=torch.int32)
    assert reference.mismatches(a, a) == 0
    assert reference.mismatches(a[:4], a) == 5
    b = a.clone()
    b[3] = 0
    assert reference.mismatches(b, a) == 1
