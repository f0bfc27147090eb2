"""The small modules left over from earlier slices, against the JAX
package's: the synthetic token pipeline and corpus (numpy, so equal
arrays), ``SlotPool`` (``tests/test_serving.py``'s cases), and the solver
modules' one-line wrappers (``contour``, ``connected_components``,
``fastsv``, ``label_propagation``, ``rem``), bit for bit on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.connectivity import contour as ref_contour  # noqa: E402
from repro.connectivity import fastsv as ref_fastsv  # noqa: E402
from repro.connectivity import lp as ref_lp  # noqa: E402
from repro.connectivity import unionfind as ref_unionfind  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402

from repro_torch.connectivity import contour, fastsv, lp, unionfind  # noqa: E402
from repro_torch.data import SyntheticTokenPipeline, make_corpus  # noqa: E402
from repro_torch.serving import SlotPool  # noqa: E402

from test_torch_solve import _pair  # noqa: E402


# -- the token pipeline and the corpus -----------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_batches_equal_the_reference(seed):
    ref = ref_pipeline.SyntheticTokenPipeline(vocab_size=1000, batch=4,
                                              seq_len=32, seed=seed)
    port = SyntheticTokenPipeline(vocab_size=1000, batch=4, seq_len=32,
                                  seed=seed)
    for step in (0, 1, 10, 977):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_pipeline_seek_determinism():
    p1 = SyntheticTokenPipeline(vocab_size=1000, batch=4, seq_len=32, seed=3)
    b10 = p1.batch_at(10)
    # a fresh pipeline seeked anywhere yields identical batches
    p2 = SyntheticTokenPipeline(vocab_size=1000, batch=4, seq_len=32, seed=3)
    assert (p2.seek(10).batch_at(10)["tokens"] == b10["tokens"]).all()
    # labels are next-token shifted
    assert (b10["labels"][:, :-1] == b10["tokens"][:, 1:]).all()
    # different steps differ
    assert (p1.batch_at(11)["tokens"] != b10["tokens"]).any()


def test_pipeline_iterator_matches_batch_at():
    p = SyntheticTokenPipeline(vocab_size=100, batch=2, seq_len=8, seed=1)
    it = iter(p)
    first, second = next(it), next(it)
    q = SyntheticTokenPipeline(vocab_size=100, batch=2, seq_len=8, seed=1)
    assert (first["tokens"] == q.batch_at(0)["tokens"]).all()
    assert (second["tokens"] == q.batch_at(1)["tokens"]).all()
    assert p.step == 2


@pytest.mark.parametrize("kw", [
    dict(n_docs=90, doc_len=120, vocab_size=400, dup_fraction=0.4,
         near_dup_noise=0.03, seed=7),
    dict(n_docs=40, doc_len=16, vocab_size=50, seed=0),
])
def test_corpus_equals_the_reference(kw):
    ref, port = ref_pipeline.make_corpus(**kw), make_corpus(**kw)
    assert len(ref) == len(port) == kw["n_docs"]
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- SlotPool (tests/test_serving.py's cases) ------------------------------

def test_slot_pool():
    pool = SlotPool(3)
    assert [pool.acquire() for _ in range(3)] == [0, 1, 2]
    assert pool.acquire() is None
    assert pool.n_busy == 3
    pool.release(1)
    assert pool.acquire() == 1
    with pytest.raises(ValueError):
        pool.release(7)
    pool.release(0)
    with pytest.raises(ValueError):
        pool.release(0)   # double release


def test_slot_pool_lowest_first():
    pool = SlotPool(4)
    a, b = pool.acquire(), pool.acquire()
    pool.release(a)
    assert pool.acquire() == a   # lowest free id again
    assert pool.n_free == 2 and b == 1
    with pytest.raises(ValueError):
        SlotPool(0)


# -- the solver modules' one-line wrappers ---------------------------------

def _same(ref, port):
    ref, port = np.asarray(ref), port.numpy()
    assert ref.dtype == port.dtype and ref.shape == port.shape
    np.testing.assert_array_equal(ref, port)


def test_contour_state_has_the_reference_fields():
    assert contour.ContourState._fields == ref_contour.ContourState._fields
    s = contour.ContourState(torch.arange(3), torch.tensor(0, dtype=torch.int32),
                             torch.tensor(False))
    assert s.L.tolist() == [0, 1, 2] and not bool(s.done)


@pytest.mark.parametrize("gname", ["rmat10", "components_mix", "path"])
@pytest.mark.parametrize("variant", ["C-2", "C-1", "C-Syn"])
def test_contour_wrappers_match_the_reference(gname, variant):
    ref_g, g = _pair(gname)
    for a, b in zip(ref_contour.contour(ref_g, variant=variant),
                    contour.contour(g, variant=variant)):
        _same(a, b)
    _same(ref_contour.connected_components(ref_g, variant=variant),
          contour.connected_components(g, variant=variant))


@pytest.mark.parametrize("gname", ["rmat10", "components_mix", "cycle"])
def test_baseline_wrappers_match_the_reference(gname):
    ref_g, g = _pair(gname)
    for ref_out, port_out in (
            (ref_fastsv.fastsv(ref_g), fastsv.fastsv(g)),
            (ref_fastsv.fastsv(ref_g, max_iters=2),
             fastsv.fastsv(g, max_iters=2)),
            (ref_lp.label_propagation(ref_g), lp.label_propagation(g)),
            (ref_lp.label_propagation(ref_g, max_iters=3),
             lp.label_propagation(g, max_iters=3)),
            (ref_unionfind.rem(ref_g), unionfind.rem(g))):
        for a, b in zip(ref_out, port_out):
            _same(a, b)
    # rem warm-started from the converged labels
    warm = np.asarray(ref_contour.connected_components(ref_g))
    for a, b in zip(ref_unionfind.rem(ref_g, init_labels=warm),
                    unionfind.rem(g, init_labels=torch.as_tensor(warm.copy()))):
        _same(a, b)
    assert unionfind.__all__ == ref_unionfind.__all__
