"""Connectivity-as-a-service on the card: request batching over the
stream (the port's ``repro.serving``).

Public surface::

    from repro_torch.serving import ConnectivityEngine, ConnectivityClient

    with ConnectivityEngine(n_vertices=1_000_000) as eng:   # on cuda
        client = ConnectivityClient(eng)
        client.ingest(src, dst)                 # blocks for the ack
        client.same_component(0, 42)            # coalesced device gather

See DESIGN.md §13 for the architecture and
``repro_torch.serving.simulate`` for the heavy-traffic harness.
"""
from repro_torch.serving.client import ConnectivityClient
from repro_torch.serving.engine import (ConnectivityEngine, DeadlineExceeded,
                                        EngineClosed, IngestAck)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.primitives import (BoundedQueue, QueueFull,
                                            ServeRequest, pow2_bucket)

__all__ = [
    "BoundedQueue",
    "ConnectivityClient",
    "ConnectivityEngine",
    "DeadlineExceeded",
    "EngineClosed",
    "IngestAck",
    "QueueFull",
    "ServeRequest",
    "ServingMetrics",
    "pow2_bucket",
]
