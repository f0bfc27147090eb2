"""The port's MinHash-LSH dedup against the JAX package's.

The same seeded documents go through ``repro.data.dedup`` and
``repro_torch.data.dedup`` (on CPU tensors): signatures, candidate
pairs, clusters and the whole ``DedupReport`` must be equal, one-shot
and streaming, and a streaming dedup's checkpointed state continues in
either package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import dedup as ref_dedup  # noqa: E402
from repro_torch.data import make_corpus  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import dedup  # noqa: E402

CPU = "cpu"


def _docs(seed=7, n_docs=90):
    return make_corpus(n_docs=n_docs, doc_len=120, vocab_size=400,
                       dup_fraction=0.4, near_dup_noise=0.03, seed=seed)


def same_report(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.keep, b.keep)
    assert (a.n_clusters, a.n_candidate_pairs, a.cc_iterations) == \
        (b.n_clusters, b.n_candidate_pairs, b.cc_iterations)


def test_signatures_and_pairs_equal_reference():
    docs = _docs()
    sigs = dedup.minhash_signatures(docs, n_hashes=32, seed=3)
    np.testing.assert_array_equal(
        sigs, ref_dedup.minhash_signatures(docs, n_hashes=32, seed=3))
    for a, b in zip(dedup.lsh_candidate_pairs(sigs, bands=8),
                    ref_dedup.lsh_candidate_pairs(sigs, bands=8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,variant", [(7, "C-2"), (5, "C-m"),
                                          (9, "C-2")])
def test_one_shot_equals_reference(seed, variant):
    docs = (_docs(seed) if seed != 9 else
            [np.random.default_rng(9).integers(0, 10_000, 64)
             for _ in range(30)])
    ours = dedup.minhash_dedup(docs, n_hashes=32, bands=8, variant=variant,
                               device=CPU)
    same_report(ours, ref_dedup.minhash_dedup(docs, n_hashes=32, bands=8,
                                              variant=variant))
    keep = np.flatnonzero(ours.keep)
    assert (ours.labels[keep] == keep).all()


@pytest.mark.parametrize("batch_size", (7, 30, 90))
def test_streaming_equals_reference(batch_size):
    docs = _docs()
    ours = dedup.StreamingDedup(n_hashes=32, bands=8, device=CPU)
    theirs = ref_dedup.StreamingDedup(n_hashes=32, bands=8)
    for pos in range(0, len(docs), batch_size):
        ids = ours.add_docs(docs[pos:pos + batch_size])
        np.testing.assert_array_equal(
            ids, theirs.add_docs(docs[pos:pos + batch_size]))
        np.testing.assert_array_equal(ours.labels(), theirs.labels())
    same_report(ours.report(), theirs.report())
    # the streamed clusters are the one-shot pass's
    np.testing.assert_array_equal(
        ours.labels(),
        dedup.minhash_dedup(docs, n_hashes=32, bands=8, device=CPU).labels)
    for doc in range(len(docs)):
        assert ours.is_duplicate(doc) == theirs.is_duplicate(doc)


def test_streaming_empty_and_single_batches():
    sd = dedup.StreamingDedup(n_hashes=32, bands=8, device=CPU)
    assert sd.add_docs([]).size == 0
    ids = sd.add_docs([np.random.default_rng(1).integers(0, 500, 64)])
    assert ids.tolist() == [0] and sd.labels().tolist() == [0]
    assert not sd.is_duplicate(0)
    assert sd.engine.device == torch.device(CPU)


@pytest.mark.chaos
def test_streaming_state_continues_across_packages(tmp_path):
    docs = _docs(n_docs=120)
    ours = dedup.StreamingDedup(n_hashes=32, bands=8, device=CPU)
    theirs = ref_dedup.StreamingDedup(n_hashes=32, bands=8)
    for pos in range(0, 60, 20):
        ours.add_docs(docs[pos:pos + 20])
    # through the port's checkpoint manager (nested state) into the
    # reference, and the reference's state straight into the port
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, ours.state_dict())
    like = {"buckets": 0, "n_docs": 0, "n_pairs": 0,
            "engine": {k: 0 for k in
                       ours.engine._STATE_KEYS}}
    state, _ = mgr.restore(like)
    theirs.load_state_dict(state)
    back = dedup.StreamingDedup(n_hashes=32, bands=8, device=CPU)
    back.load_state_dict({k: (v if k != "engine" else
                              {ek: np.asarray(ev) for ek, ev in v.items()})
                          for k, v in theirs.state_dict().items()})
    for pos in range(60, 120, 20):
        for d in (ours, theirs, back):
            d.add_docs(docs[pos:pos + 20])
    same_report(ours.report(), theirs.report())
    same_report(back.report(), theirs.report())
