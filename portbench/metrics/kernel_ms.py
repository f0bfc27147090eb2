"""kernel_ms: the device time of the port's own kernels a call, ms: CUDA
events around every launch through the connectivity libraries,
averaged over the traced calls."""


def read(record):
    calls = [c for c in record["calls"] if "launches" in c]
    if not calls or not any(c["launches"] for c in calls):
        return None
    return sum(ms for c in calls for _, ms in c["launches"]) / len(calls)
