"""Deterministic, seekable token data pipeline (the port's copy of
``repro.data.pipeline``; numpy only, so the arrays are the reference's).

Restart-exactness is the data-side half of fault tolerance: batch ``k`` is
a pure function of ``(seed, k)`` (counter-based RNG), so a job restored
from a step-``k`` checkpoint consumes exactly the batches it would have —
no pipeline state to checkpoint, any host can produce any shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class SyntheticTokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0

    def seek(self, step: int) -> "SyntheticTokenPipeline":
        self.step = step
        return self

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: independent stream per (seed, step)
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        # zipf-ish marginal over the vocab: realistic logit scale for CE
        raw = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        tokens = (raw - 1) % self.vocab_size
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b


def make_corpus(
    n_docs: int,
    doc_len: int,
    vocab_size: int,
    *,
    dup_fraction: float = 0.3,
    near_dup_noise: float = 0.05,
    seed: int = 0,
) -> List[np.ndarray]:
    """Synthetic corpus with planted (near-)duplicate clusters.

    ``dup_fraction`` of documents are noisy copies of earlier documents —
    the ground truth the MinHash+Contour dedup stage must recover.
    """
    rng = np.random.default_rng(seed)
    docs: List[np.ndarray] = []
    for i in range(n_docs):
        if docs and rng.random() < dup_fraction:
            base = docs[int(rng.integers(len(docs)))].copy()
            flip = rng.random(base.shape[0]) < near_dup_noise
            base[flip] = rng.integers(0, vocab_size, flip.sum())
            docs.append(base)
        else:
            docs.append(rng.integers(0, vocab_size, doc_len).astype(np.int64))
    return docs
