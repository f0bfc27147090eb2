"""host_reads: the program's reads of a device value on the host a call,
by its own ``read.*`` spans (``repro_torch.trace``), averaged over the
traced calls: what ``host_syncs`` counts from outside."""
from portbench import spans


def read(record):
    calls = spans.solve_calls()
    if not calls:
        return None
    return sum(len(c.named("read.")) for c in calls) / len(calls)
