"""Data pipelines of the port: the seekable synthetic token pipeline and
MinHash-LSH deduplication over the card's connected components
(``repro.data``)."""
from repro_torch.data.dedup import (DedupReport, StreamingDedup,
                                    minhash_dedup)
from repro_torch.data.pipeline import SyntheticTokenPipeline, make_corpus

__all__ = ["DedupReport", "StreamingDedup", "SyntheticTokenPipeline",
           "make_corpus", "minhash_dedup"]
