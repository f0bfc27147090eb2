"""Data pipelines of the port: MinHash-LSH deduplication over the card's
connected components (``repro.data.dedup``)."""
from repro_torch.data.dedup import (DedupReport, StreamingDedup,
                                    minhash_dedup)

__all__ = ["DedupReport", "StreamingDedup", "minhash_dedup"]
