"""The port's roofline machinery: the op-by-op cost model on ``meta``
tensors (``roofline.op_cost``, the counterpart of the reference's HLO
parser), the collective byte model of a priced rank, the live bytes'
peak and the report's three terms against an H100's peaks; the cases of
the reference's ``tests/test_roofline.py``, on the port.

The reference's loop-once pitfall has no counterpart (a Python loop
dispatches its ops every trip), so its loop tests become: a loop counts
every trip.  The port has no collective-permute (its collectives are
all-reduce, all-gather and reduce-scatter), so the reference's permute
case has no counterpart either.
"""
import gc

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.roofline import (HW_H100, RooflineReport,  # noqa: E402
                                  analyze_program, collective_stats)
from repro_torch.roofline.op_cost import (Cost, Memory, OpCost,  # noqa: E402
                                          price, storage_bytes)
from repro_torch.runtime import mesh as rt  # noqa: E402
from repro_torch.runtime.mesh import AbstractMesh, PricedRank  # noqa: E402


def M(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cost(fn, *args):
    return price(fn, *args)[1]


def test_matmul_flops_exact():
    cost = _cost(lambda a, b: a @ b, M(512, 512), M(512, 512))
    assert cost.flops == 2 * 512 ** 3
    assert cost.ops == 1


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_einsum_bmm_addmm_and_linear_count_their_products(device):
    a = torch.zeros(4, 8, 16, device=device)
    w = torch.zeros(16, 32, device=device)
    bias = torch.zeros(32, device=device)
    cost = _cost(lambda: (torch.einsum("btd,df->btf", a, w),
                          torch.nn.functional.linear(a[0], w.T, bias),
                          torch.bmm(a, a.transpose(1, 2))))
    assert cost.flops == 2 * 32 * 32 * 16 + 2 * 8 * 32 * 16 \
        + 2 * 4 * 8 * 8 * 16


def test_python_loop_counts_every_trip():
    """The reference's scan trip-count test: 8 layers in a loop count 8
    times one layer."""
    def layers(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    one = _cost(layers, M(64, 256), [M(256, 256)])
    eight = _cost(layers, M(64, 256), [M(256, 256)] * 8)
    assert one.flops == 2 * 64 * 256 * 256
    assert eight.flops == 8 * one.flops and eight.bytes == 8 * one.bytes
    assert eight.ops == 8 * one.ops


def test_nested_loops_count_the_product_of_their_trips():
    def fn(x, wss):
        for ws in wss:
            for w in ws:
                x = torch.tanh(x @ w)
        return x

    cost = _cost(fn, M(32, 64), [[M(64, 64)] * 5] * 3)
    assert cost.flops == 15 * 2 * 32 * 64 * 64


def test_product_inside_elementwise_chain_counted():
    cost = _cost(lambda a, b: torch.tanh(a @ b) * 2.0 + 1.0,
                 M(128, 128), M(128, 128))
    assert cost.flops == 2 * 128 ** 3


def test_bytes_reasonable_for_elementwise():
    """read + write of a 4 MB array per op (two eager ops: 16 MB)."""
    cost = _cost(lambda a: a * 2.0 + 1.0, M(1024, 1024))
    assert 8e6 <= cost.bytes <= 4e7
    assert cost.bytes == 4 * 4 * 1024 * 1024


def test_views_are_free_and_ops_on_a_view_pay_its_elements():
    x = M(1000, 256)
    cost = _cost(lambda x: (x.view(256, 1000).t()[:10].unsqueeze(0),
                            x.permute(1, 0).expand(2, 256, 1000)), x)
    assert cost.bytes == 0 and cost.ops == 6
    # a reshape that cannot be a view copies: it pays its read and write
    assert _cost(lambda x: x.t().reshape(-1), x).bytes == 2 * 1000 * 256 * 4
    assert _cost(lambda x: x[7] + 1.0, x).bytes == 2 * 256 * 4


def test_indexed_ops_charged_by_the_region_they_address():
    """A 1000-step recurrence reading a row of xs a step by an index
    (gather) and writing a row (scatter): each trip pays its slice, not
    the stacked array (the naive model would pay ~1000 x 1 MB)."""
    def f(c, xs, ys):
        for i in range(1000):
            idx = torch.full((1,), i, dtype=torch.int64, device=c.device)
            c = torch.tanh(c + xs.index_select(0, idx)[0])
            ys.index_put_((idx,), c[None])
        return c

    cost = _cost(f, M(256), M(1000, 256), M(1000, 256))
    assert cost.bytes < 1e8, cost.bytes
    row = 256 * 4
    gather = 2 * row + 8
    scatter = 2 * row + 8
    assert _cost(lambda xs, i: xs.index_select(0, i), M(1000, 256),
                 M(1, dtype=torch.int64)).bytes == gather
    assert _cost(lambda ys, i, v: ys.index_put_((i,), v), M(1000, 256),
                 M(1, dtype=torch.int64), M(1, 256)).bytes == scatter


def test_copy_into_a_slice_pays_source_and_destination():
    cost = _cost(lambda buf, x: buf[:, 3:4].copy_(x), M(2, 4096, 8),
                 M(2, 1, 8))
    assert cost.bytes == 2 * (2 * 8 * 4)


def test_meta_storages_have_no_pointer_but_count_apart():
    """Every ``meta`` storage's data pointer is 0; the peak tells them
    apart by the storage object, and counts a storage once however many
    views share it."""
    a, b = M(1000), M(1000)
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    assert storage_bytes([a, b]) == 8000
    assert storage_bytes([a, a.view(10, 100), a[5:]]) == 4000
    views = [a, a[3:], b]
    with OpCost() as counter:
        assert counter.hold(views) == 8000
        assert counter.live_bytes == 8000


def test_peak_bytes_of_a_chain_freed_in_a_known_order():
    """Arguments 4 KB; x1 (4 KB) and x2 (8 KB) live together, x1 goes,
    x3 (16 KB) is made with x2 alive, x2 goes: the peak is 4 + 8 + 16
    KB, and every freed storage leaves the live count."""
    def chain(a):
        x1 = a * 2.0                                   # 4 KB
        x2 = torch.cat([x1, x1])                       # 8 KB
        del x1
        x3 = torch.cat([x2, x2])                       # 16 KB
        del x2
        return x3.sum()

    a = M(1024)
    with OpCost() as counter:
        counter.hold(a)
        out = chain(a)
        gc.collect()
        live = counter.live_bytes
    assert counter.peak_bytes == 4096 + 8192 + 16384
    assert live == 4096 + 4                 # the argument and the sum
    del out
    assert counter.live_bytes == 4096
    _, _, memory = price(chain, a)
    assert memory == Memory(argument_bytes=4096, output_bytes=4,
                            peak_bytes=4096 + 8192 + 16384)


def test_peak_counts_what_the_backward_keeps_until_it_frees_it():
    w = torch.empty(256, 256, device="meta", requires_grad=True)

    def loss_and_grad(x):
        h = torch.tanh(x @ w)            # saved for the backward
        return torch.autograd.grad(h.sum(), w)[0]

    _, cost, memory = price(loss_and_grad, M(64, 256))
    # x, w; h (saved), the sum, the gradients of h and of the product
    # and the product's input gradient at once at most
    assert memory.peak_bytes >= 64 * 256 * 4 * 3 + 256 * 256 * 4
    assert cost.flops == 2 * (2 * 64 * 256 * 256)


# ---------------------------------------------------------------------------
# the priced rank's collectives
# ---------------------------------------------------------------------------

def test_priced_rank_is_a_mesh_on_meta():
    rank = AbstractMesh((2, 16, 16), ("pod", "data", "model")).at(300)
    assert isinstance(rank, PricedRank)
    assert rank.device == torch.device("meta")
    assert rank.coordinate == (1, 2, 12)
    assert rank.shard_index(("pod", "data")) == 18
    assert rank.group_ranks(("model",)) == tuple(range(288, 304))
    with pytest.raises(RuntimeError):
        rank.group(("model",))
    with pytest.raises(ValueError):
        AbstractMesh((2, 2), ("data", "model")).at(4)


def test_collective_parse_shapes_and_groups():
    """The reference's case: an all-reduce of f32[1024] over 8 ranks and
    an all-gather to bf16[64, 128] over 16, by the ring model."""
    r8 = AbstractMesh((4, 8), ("data", "model")).at(0)
    r16 = AbstractMesh((2, 16), ("data", "model")).at(0)
    out = rt.all_reduce(M(1024), r8, ("model",))
    assert out.shape == (1024,) and out.device.type == "meta"
    got = rt.all_gather(M(4, 128, dtype=torch.bfloat16), r16, ("model",), 0)
    assert got.shape == (64, 128) and got.dtype == torch.bfloat16
    cost = Cost()
    cost.add_collectives(r8.records + r16.records)
    assert cost.coll_counts == {"all-reduce": 1, "all-gather": 1}
    assert cost.coll_link_bytes["all-reduce"] == pytest.approx(
        2 * 1024 * 4 * (7 / 8))
    assert cost.coll_link_bytes["all-gather"] == pytest.approx(
        64 * 128 * 2 * (15 / 16))
    assert cost.bytes == 2 * 4096 + (4 * 128 * 2 + 64 * 128 * 2)


def test_reduce_scatter_as_nccl_runs_it():
    """NCCL's reduce-scatter is one collective (out x (n - 1) on the
    link); over axes not in the mesh's order it is an all-reduce and the
    rank's block, as on a live rank."""
    rank = AbstractMesh((2, 4), ("data", "model")).at(5)
    out = rt.reduce_scatter(M(8, 16), rank, ("model",), 0)
    assert out.shape == (2, 16)
    assert [r.kind for r in rank.records] == ["reduce_scatter"]
    stats = collective_stats(rank.records)
    assert stats.link_bytes == {"reduce-scatter": 2 * 16 * 4 * 3}
    out = rt.reduce_scatter(M(8, 16), rank, ("model", "data"), 0)
    assert out.shape == (1, 16)
    assert rank.records[-1] == (
        "all_reduce", 8, 8 * 16 * 4, 8 * 16 * 4)


def test_collectives_in_a_loop_multiplied():
    rank = AbstractMesh((1, 4), ("data", "model")).at(2)
    x = M(8)
    for _ in range(12):
        x = rt.all_reduce(x, rank, ("model",), dist.ReduceOp.MIN)
    _, cost, _ = price(lambda: None, mesh=rank)
    assert cost.coll_counts == {}
    cost.add_collectives(rank.records)
    assert cost.coll_counts["all-reduce"] == 12
    assert cost.coll_link_bytes["all-reduce"] == pytest.approx(
        12 * 2 * 32 * (3 / 4))


def test_a_size_one_axis_records_nothing():
    rank = AbstractMesh((1, 4), ("data", "model")).at(0)
    rt.all_reduce(M(8), rank, ("data",))
    rt.all_gather(M(8), rank, ("data",), 0)
    assert rank.records == []


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def test_report_three_terms_and_dominant():
    rep = RooflineReport(
        arch="a", shape="s", mesh="m", kind="train", n_devices=256,
        hlo_flops=9.89e12, hlo_bytes=3.35e11, collective_link_bytes=4.5e10,
        peak_hbm_bytes=8e9, model_flops_global=9.89e12 * 256 * 0.5,
    ).finalize()
    assert rep.t_compute == pytest.approx(0.01)        # 9.89e12/989e12
    assert rep.t_memory == pytest.approx(0.1)          # 3.35e11/3.35e12
    assert rep.t_collective == pytest.approx(0.1)      # 4.5e10/450e9
    assert rep.dominant in ("memory", "collective")
    assert rep.flops_ratio == pytest.approx(0.5)
    assert HW_H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                       "link_bw": 450e9, "alu_ops": 67e12}


def test_analyze_program_of_a_priced_matmul():
    rank = AbstractMesh((2, 2), ("data", "model")).at(3)

    def program(a, b):
        return rt.all_reduce(a @ b, rank, ("model",))

    _, cost, memory = price(program, M(256, 512), M(512, 256), mesh=rank)
    rep = analyze_program(cost, memory, arch="a", shape="s", mesh_name="m",
                          kind="prefill", n_devices=4,
                          model_flops_global=4 * 2 * 256 * 512 * 256)
    assert rep.hlo_flops == 2 * 256 * 512 * 256
    assert rep.flops_ratio == pytest.approx(1.0)
    assert rep.collective_link_bytes == 2 * 256 * 256 * 4 * (1 / 2)
    assert rep.t_compute == pytest.approx(rep.hlo_flops / 989e12)
    assert rep.collective_detail["counts"] == {"all-reduce": 1}
    assert memory.argument_bytes == 2 * 256 * 512 * 4
    assert memory.peak_bytes == memory.argument_bytes + 2 * 256 * 256 * 4
