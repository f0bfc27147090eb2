"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, cheaply: the cells it lists, what a priced rank is given on
both production meshes against the reference's blocks, ranks that price
alike, and the records it writes.  The product FLOPs of every smoke
config against the reference's compiled programs are in
``tests/test_torch_dryrun_flops.py``.

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` to
512 host devices at import, which would reach every later test of the
same worker; the expected cells come from ``repro.configs``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import input_specs as ref_input_specs  # noqa: E402
from repro.jax_compat import abstract_mesh  # noqa: E402
from repro.models import common as ref_cm  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.roofline.analysis import \
    RooflineReport as RefReport  # noqa: E402

from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.kernels.contour_mm import blocked  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.roofline.op_cost import price, storage_bytes  # noqa: E402

ARCH_NAMES = sorted(REF_ARCHS)
CHEAP = ("olmo-1b", "decode_32k")          # ~2 s a rank on meta


def _ref_mesh(multi: bool):
    if multi:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def _block_bytes(sds, spec, mesh) -> int:
    """The bytes of one device's block of ``sds`` laid out as ``spec``."""
    shape = list(sds.shape)
    for dim, entry in enumerate(tuple(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            shape[dim] //= mesh.shape[a]
    return int(np.prod(shape, dtype=np.int64)) * jnp.dtype(sds.dtype).itemsize


def _tree_block_bytes(shapes, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(specs)
    assert len(leaves) == len(spec_leaves)
    return sum(_block_bytes(s, p, mesh) for s, p in zip(leaves, spec_leaves))


def _batch_bytes(arch, shape_name, config, mesh) -> int:
    rules = ref_cm.make_rules(config, mesh)
    total = 0
    for key, sds in ref_input_specs(arch, shape_name).items():
        if REF_SHAPES[shape_name].kind == "decode" and key != "tokens":
            continue
        axes = dryrun._batch_axes(key, sds)
        total += _block_bytes(
            sds, ref_cm.resolve_spec(sds.shape, axes, mesh, rules), mesh)
    return total


def ref_argument_bytes(name: str, kind: str, shape_name: str,
                       multi: bool) -> int:
    """One device's argument bytes of the reference's cell, from its
    abstract tree and ``shardings_for``/``cache_shardings`` (no compile):
    the state or parameters, the batch's block and, for decode, the
    cache's blocks (its ``length`` arrays left out: the port's cache
    length is a Python int)."""
    arch = ref_get_arch(name)
    mesh = _ref_mesh(multi)
    config = arch.config if kind == "train" else arch.config.for_serving()
    model = ref_build(config)
    specs = model.param_specs()
    pshapes = ref_cm.abstract_tree(specs, config.param_dtype)
    pspecs = jax.tree_util.tree_map(
        lambda s: s.spec, ref_cm.shardings_for(specs, config, mesh),
        is_leaf=lambda x: hasattr(x, "spec"))
    total = _tree_block_bytes(pshapes, pspecs, mesh)
    if kind == "train":
        moment = 2 if config.param_dtype == jnp.bfloat16 else 4
        total = total + 2 * (total // jnp.dtype(config.param_dtype).itemsize
                             * moment) + 4
        return total + _batch_bytes(arch, shape_name, config, mesh)
    total += _batch_bytes(arch, shape_name, config, mesh)
    if kind == "decode":
        shape = REF_SHAPES[shape_name]
        kw = {"src_len": arch.src_frames} if config.family == "audio" else {}
        cache = jax.eval_shape(lambda: model.init_cache(
            shape.global_batch, shape.seq_len, **kw))
        plan = getattr(model, "dec_plan", None) or model.plan
        shardings = ref_tfm.resolve_cache_shardings(
            ref_tfm.cache_shardings(config, mesh, plan), cache)
        leaves = jax.tree_util.tree_leaves_with_path(cache)
        specs = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))
        total += sum(_block_bytes(s, p.spec, mesh)
                     for (path, s), p in zip(leaves, specs)
                     if "length" not in jax.tree_util.keystr(path))
    return total


def test_the_list_is_the_references_41_cells(capsys):
    dryrun.main(["--list"])
    got = [tuple(line.split()) for line in capsys.readouterr().out.split(
        "\n") if line]
    want = [(a, s) for a in REF_ARCHS for s in REF_SHAPES] + [
        ("contour-cc", "graph_2e31")]
    assert got == want and len(got) == 41


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_argument_bytes_are_the_references_blocks(name, multi):
    """Each train and serve cell's priced rank is given exactly its
    blocks: the state (moments bf16 where the parameters are), the
    batch's block and, for decode, the cache's blocks."""
    mesh = make_production_mesh(multi_pod=multi)
    arch = get_arch(name)
    checked = 0
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        if arch.skip_reason(shape_name):
            continue
        shape = SHAPES[shape_name]
        _, args = dryrun.PROGRAMS[shape.kind](arch, shape, mesh.at(0))
        assert storage_bytes(args) == ref_argument_bytes(
            name, shape.kind, shape_name, multi), shape_name
        checked += 1
    assert checked >= 1


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_smoke_program_runs_on_meta_with_and_without_a_mesh(name):
    """The smoke config's train step, prefill and decode (32 sequences of
    16 tokens) run on ``meta`` with no mesh and on a priced rank of each
    production mesh (rank 0 of one, the last of the other)."""
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.step import TrainState, make_train_step
    b, t = 32, 16
    for rank in (None, make_production_mesh().at(0),
                 make_production_mesh(multi_pod=True).at(511)):
        for kind in ("train", "prefill", "decode"):
            config = get_arch(name).smoke_config()
            if kind != "train":
                config = config.for_serving()
            model = build_model(config, rank, device="meta")
            params = model.params()
            batch = {"tokens": _meta((b, t)), "labels": _meta((b, t))}
            if config.frontend == "patch_stub":
                batch["patch_embeds"] = _meta(
                    (b, config.n_frontend_tokens, config.d_model),
                    config.dtype)
            if config.frontend == "audio_stub":
                batch["frame_embeds"] = _meta((b, t, config.d_model),
                                              config.dtype)
            if kind == "train":
                opt = OptConfig()
                state = TrainState(params, init_opt_state(params, opt))
                fn, args = make_train_step(model, opt), (state, batch)
            elif kind == "prefill":
                del batch["labels"]
                fn, args = model.prefill, (params, batch)
            else:
                kw = {"src_len": t} if config.family == "audio" else {}
                fn, args = model.decode_step, (
                    params, _meta((b, 1)), model.init_cache(b, t, **kw))
            _, cost, memory = price(fn, *args, mesh=rank)
            assert cost.flops > 0 and memory.peak_bytes > 0, (kind, rank)
            assert rank is None or cost.coll_counts, (kind, rank)


def test_rank_zero_and_the_last_rank_price_alike():
    arch, shape = get_arch(CHEAP[0]), SHAPES[CHEAP[1]]
    mesh = make_production_mesh(multi_pod=True)
    first, last = mesh.at(0), mesh.at(mesh.size - 1)
    cost0, memory0 = dryrun.trace_cell(arch, shape, first)
    cost1, memory1 = dryrun.trace_cell(arch, shape, last)
    assert cost0 == cost1 and memory0 == memory1
    assert cost0.flops > 0 and cost0.coll_counts
    assert [r[:2] for r in first.records] == [r[:2] for r in last.records]


def test_a_cell_record_carries_the_references_keys(tmp_path):
    rec = dryrun.run_cell(*CHEAP, "single", str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    # lower_s/compile_s become trace_s; XLA's temp/alias/code bytes have
    # no counterpart
    assert set(rec) == {"arch", "shape", "mesh", "status", "trace_s",
                        "memory", "roofline"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "peak_bytes"}
    assert set(rec["roofline"]) == {f.name for f in
                                    dataclasses.fields(RefReport)}
    report = rec["roofline"]
    assert report["kind"] == "decode" and report["n_devices"] == 256
    assert report["dominant"] in ("compute", "memory", "collective")
    assert report["peak_hbm_bytes"] == rec["memory"]["peak_bytes"]
    written = tmp_path / "olmo-1b__decode_32k__pod1x16x16.json"
    assert json.loads(written.read_text()) == json.loads(json.dumps(rec))


def test_a_skipped_cell_carries_the_references_reason(tmp_path):
    rec = dryrun.run_cell("olmo-1b", "long_500k", "multi", str(tmp_path))
    assert rec == {"arch": "olmo-1b", "shape": "long_500k",
                   "mesh": "pod2x16x16", "status": "skipped",
                   "reason": ref_get_arch("olmo-1b").skip_reason(
                       "long_500k")}


@pytest.mark.parametrize("which", ["single", "multi"])
def test_the_contour_cell_is_the_kernels_rounds(tmp_path, which):
    """contour-cc: 8 rounds of K1 + K7 + K6 over the rank's edge block
    (the kernels' own work functions), the labels' and the flag's
    all-reduce over the edge axes; no FLOPs."""
    rec = dryrun.run_cell("contour-cc", "graph_2e31", which, str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    n, shards = 1 << 28, 16 if which == "single" else 32
    m = (1 << 31) // shards
    work = [blocked.fused_relax_work(n, m), cv.pointer_jump_work(n),
            cv.converged_early_work(n, m)]
    assert rec["contour"]["round"]["bytes"] == sum(b for b, _ in work)
    assert rec["contour"]["round"]["ops"] == sum(o for _, o in work)
    report = rec["roofline"]
    assert report["hlo_flops"] == 0 and report["kind"] == "contour"
    frac = (shards - 1) / shards
    assert report["collective_link_bytes"] == pytest.approx(
        8 * (int(2 * 4 * n * frac) + int(2 * 4 * frac)))
    assert report["collective_detail"]["counts"] == {"all-reduce": 16}
    assert report["hlo_bytes"] == 8 * (sum(b for b, _ in work)
                                       + 2 * 4 * n + 2 * 4)


def test_a_one_rank_contour_round_is_the_kernels_bounds():
    """On a 1-rank mesh no collective runs and a round's bytes and
    operations are the kernels' own (what ``chip_smoke.py``'s
    ``roofline_path`` holds against the kernels line)."""
    from repro_torch.runtime.mesh import AbstractMesh
    rank = AbstractMesh((1, 1), ("data", "model")).at(0)
    n, m = 1 << 22, 1 << 26
    cost, memory, work = dryrun.trace_contour(rank, n, m, rounds=1)
    assert rank.records == [] and cost.coll_counts == {}
    assert cost.bytes == work["bytes"] == (8 * n + 8 * m) + 8 * n \
        + (8 * m + 4 * n)
    assert work["ops"] == 5 * m + n + 3 * m


def test_an_errored_cell_is_recorded_and_fails_the_run(tmp_path,
                                                       monkeypatch):
    def broken(*args):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "trace_cell", broken)
    rec = dryrun.run_cell(*CHEAP, "single", str(tmp_path))
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: boom"
    assert "Traceback" in rec["traceback"]
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", CHEAP[0], "--shape", CHEAP[1], "--mesh",
                     "single", "--out", str(tmp_path)])
    assert exit_.value.code == 1
