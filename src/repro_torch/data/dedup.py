"""MinHash-LSH near-duplicate detection with Contour connected components.

The port's counterpart of ``repro.data.dedup``: the same signatures,
bands and candidate pairs (numpy, on the host), with the connected
components step on the port's ``solve`` and ``StreamingConnectivity``,
on the card unless ``device=`` names another.

This is the production integration of the paper's algorithm (DESIGN.md §5):
RefinedWeb/SlimPajama-style dedup builds a similarity graph from MinHash
LSH collisions and needs connected components to turn pairwise collisions
into duplicate *clusters* — at corpus scale the CC step is the scalability
bottleneck, which is exactly the regime Contour targets (massive edge
parallelism, tiny iteration count).

Pipeline: shingle -> MinHash signatures -> LSH banding -> candidate pairs
-> Contour CC -> keep the minimum doc id per cluster (Contour's min-label
fixed point *is* the canonical representative).

Two entry points:

* :func:`minhash_dedup` — one batch pass over a finite corpus;
* :class:`StreamingDedup` — the *online* form: documents arrive in
  micro-batches, each batch's LSH collisions are ingested into a
  :class:`~repro_torch.connectivity.streaming.StreamingConnectivity`
  engine,
  and cluster membership is queryable after every batch without
  re-solving (serve-path dedup: "is this an already-seen page?").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.connectivity import (SolveOptions, StreamingConnectivity,
                                      solve)
from repro_torch.graphs.structs import (DeviceLike, Graph,
                                        canonicalize_edges)

_MERSENNE = (1 << 61) - 1


@dataclasses.dataclass
class DedupReport:
    labels: np.ndarray          # cluster label (min doc id) per doc
    keep: np.ndarray            # bool per doc: cluster representative?
    n_clusters: int
    n_candidate_pairs: int
    cc_iterations: int


def _shingles(doc: np.ndarray, k: int) -> np.ndarray:
    if doc.shape[0] < k:
        return doc[None, :].copy() if doc.shape[0] else np.zeros((1, 1), np.int64)
    return np.lib.stride_tricks.sliding_window_view(doc, k)


def minhash_signatures(
    docs: Sequence[np.ndarray], n_hashes: int = 64, shingle: int = 5, seed: int = 0
) -> np.ndarray:
    """(n_docs, n_hashes) int64 MinHash signatures."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE, n_hashes, dtype=np.int64)
    b = rng.integers(0, _MERSENNE, n_hashes, dtype=np.int64)
    sigs = np.empty((len(docs), n_hashes), np.int64)
    for i, doc in enumerate(docs):
        sh = _shingles(np.asarray(doc, np.int64), shingle)
        # polynomial-hash each shingle to one 61-bit value
        h = np.zeros(sh.shape[0], np.int64)
        for c in range(sh.shape[1]):
            h = (h * np.int64(1_000_003) + sh[:, c]) % _MERSENNE
        hv = (h[:, None] * a[None, :] + b[None, :]) % _MERSENNE
        sigs[i] = hv.min(axis=0)
    return sigs


def _band_keys(sigs: np.ndarray, bands: int) -> np.ndarray:
    """(n_docs, bands) int64 bucket key per band.

    The single definition of the band hash: both the batch pass
    (:func:`lsh_candidate_pairs`) and the streaming pass
    (:class:`StreamingDedup`) bucket through it, which is what makes
    their cluster partitions bit-identical.
    """
    n_docs, n_hashes = sigs.shape
    assert n_hashes % bands == 0
    rows = n_hashes // bands
    keys = np.empty((n_docs, bands), np.int64)
    for b in range(bands):
        band = sigs[:, b * rows:(b + 1) * rows]
        key = np.zeros(n_docs, np.int64)
        for c in range(rows):
            key = (key * np.int64(1_000_003) + band[:, c]) % _MERSENNE
        keys[:, b] = key
    return keys


def lsh_candidate_pairs(
    sigs: np.ndarray, bands: int = 16
) -> tuple[np.ndarray, np.ndarray]:
    """Band the signatures; docs sharing any band bucket become an edge."""
    keys = _band_keys(sigs, bands)
    srcs, dsts = [], []
    for b in range(bands):
        key = keys[:, b]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        # group boundaries; chain consecutive members of each bucket
        same = ks[1:] == ks[:-1]
        srcs.append(order[:-1][same])
        dsts.append(order[1:][same])
    if not srcs:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return np.concatenate(srcs).astype(np.int64), np.concatenate(dsts).astype(np.int64)


def minhash_dedup(
    docs: Sequence[np.ndarray],
    *,
    n_hashes: int = 64,
    bands: int = 16,
    shingle: int = 5,
    seed: int = 0,
    variant: str = "C-2",
    device: DeviceLike = None,
) -> DedupReport:
    """Full dedup pass; the CC step runs the paper's Contour algorithm on
    ``device`` (``cuda`` unless named)."""
    n = len(docs)
    sigs = minhash_signatures(docs, n_hashes=n_hashes, shingle=shingle, seed=seed)
    src, dst = lsh_candidate_pairs(sigs, bands=bands)
    src, dst = canonicalize_edges(src, dst, n)
    if src.shape[0] == 0:
        labels = np.arange(n)
        return DedupReport(labels, np.ones(n, bool), n, 0, 0)
    g = Graph.from_numpy(src, dst, n, device=device)
    result = solve(g, SolveOptions(algorithm="contour", variant=variant))
    labels = result.labels.cpu().numpy()
    keep = labels == np.arange(n)
    return DedupReport(
        labels=labels,
        keep=keep,
        n_clusters=int(keep.sum()),
        n_candidate_pairs=int(src.shape[0]),
        cc_iterations=int(result.iterations),
    )


class StreamingDedup:
    """Online MinHash-LSH dedup over document micro-batches.

    Maintains, per LSH band, a host dict ``bucket key -> first doc id``;
    each new document that lands in an occupied bucket contributes one
    candidate edge to its bucket's representative — within a bucket that
    chains every member into one component, the same partition the batch
    path's consecutive-pair chaining produces.  The edges stream into a
    :class:`StreamingConnectivity` engine (vertex set grown per batch),
    so ``labels()``/``is_duplicate()`` answer after every batch from the
    resident converged labels — no per-query re-solve.

    The MinHash parameters are seeded identically to
    :func:`minhash_signatures`, so a streamed corpus clusters exactly
    like the one-shot :func:`minhash_dedup` pass over the same docs.
    The engine lives on ``device`` (``cuda`` unless named).
    """

    def __init__(self, *, n_hashes: int = 64, bands: int = 16,
                 shingle: int = 5, seed: int = 0,
                 options: Optional[SolveOptions] = None,
                 device: DeviceLike = None):
        self._kw = dict(n_hashes=n_hashes, shingle=shingle, seed=seed)
        self._bands = bands
        self._buckets: List[Dict[int, int]] = [dict() for _ in range(bands)]
        self._n_docs = 0
        self._n_pairs = 0
        self._engine = StreamingConnectivity(
            0, options if options is not None
            else SolveOptions(algorithm="contour"), device=device)

    @property
    def engine(self) -> StreamingConnectivity:
        """The underlying connectivity engine (for snapshots/counters)."""
        return self._engine

    @property
    def n_docs(self) -> int:
        return self._n_docs

    @property
    def n_candidate_pairs(self) -> int:
        return self._n_pairs

    def add_docs(self, docs: Sequence[np.ndarray]) -> np.ndarray:
        """Ingest a document micro-batch; returns the new docs' ids."""
        ids = np.arange(self._n_docs, self._n_docs + len(docs))
        if not len(docs):
            return ids
        sigs = minhash_signatures(docs, n_hashes=self._kw["n_hashes"],
                                  shingle=self._kw["shingle"],
                                  seed=self._kw["seed"])
        keys = _band_keys(sigs, self._bands)
        srcs, dsts = [], []
        for i, doc_id in enumerate(ids):
            for b in range(self._bands):
                rep = self._buckets[b].setdefault(int(keys[i, b]),
                                                  int(doc_id))
                if rep != doc_id:
                    srcs.append(rep)
                    dsts.append(int(doc_id))
        self._n_docs += len(docs)
        self._n_pairs += len(srcs)
        self._engine.ingest(np.asarray(srcs, np.int64),
                            np.asarray(dsts, np.int64),
                            n_vertices=self._n_docs)
        return ids

    def labels(self) -> np.ndarray:
        """Cluster label (min doc id) per ingested doc, on the host."""
        return self._engine.labels.cpu().numpy()

    def is_duplicate(self, doc_id) -> bool:
        """True iff ``doc_id`` is not its cluster's representative."""
        return int(self._engine.component_of(doc_id)) != int(doc_id)

    # -- checkpointing (DESIGN.md §12) -----------------------------------
    def state_dict(self) -> dict:
        """Full checkpointable state: LSH buckets + the engine's state.

        The per-band bucket dicts are packed into one ``[P, 3]``
        ``(band, key, representative)`` array so the whole thing is a
        flat array pytree for ``CheckpointManager``; the nested
        ``"engine"`` entry is the connectivity engine's own
        :meth:`~repro_torch.connectivity.StreamingConnectivity.state_dict`.
        """
        triples = [(b, k, rep)
                   for b, bucket in enumerate(self._buckets)
                   for k, rep in bucket.items()]
        return {
            "buckets": np.asarray(triples, np.int64).reshape(-1, 3),
            "n_docs": np.int64(self._n_docs),
            "n_pairs": np.int64(self._n_pairs),
            "engine": self._engine.state_dict(),
        }

    def load_state_dict(self, state: dict) -> "StreamingDedup":
        """Restore to a :meth:`state_dict` snapshot in place (the MinHash
        parameters are construction-time config, not state — build the
        instance with the same ``n_hashes``/``bands``/``shingle``/
        ``seed`` to resume identically)."""
        buckets: List[Dict[int, int]] = [dict() for _ in range(self._bands)]
        for band, key, rep in np.asarray(state["buckets"],
                                         np.int64).reshape(-1, 3):
            if not 0 <= band < self._bands:
                raise ValueError(
                    f"corrupt checkpoint: band {band} outside "
                    f"[0, {self._bands})")
            buckets[int(band)][int(key)] = int(rep)
        self._buckets = buckets
        self._n_docs = int(state["n_docs"])
        self._n_pairs = int(state["n_pairs"])
        self._engine.load_state_dict(state["engine"])
        return self

    def report(self) -> DedupReport:
        """Cumulative :class:`DedupReport` over everything streamed."""
        labels = self.labels()
        keep = labels == np.arange(self._n_docs)
        return DedupReport(
            labels=labels,
            keep=keep,
            n_clusters=int(keep.sum()),
            n_candidate_pairs=self._n_pairs,
            cc_iterations=int(self._engine.snapshot().iterations),
        )
