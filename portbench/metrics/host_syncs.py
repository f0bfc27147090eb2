"""host_syncs: the host's waits for the device a call, as
``torch.cuda.set_sync_debug_mode("warn")`` flags them inside the port,
averaged over the traced calls."""


def read(record):
    counts = [c["host_syncs"] for c in record["calls"] if "host_syncs" in c]
    if not counts:
        return None
    return sum(counts) / len(counts)
