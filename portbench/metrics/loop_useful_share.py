"""loop_useful_share: the share of the Contour loop's enqueued iterations
that did work, %: 100 x the sum of the ``loop.iterations`` counters
(the state's ``it`` at the last read) over the sum of the
``loop.enqueued`` counters (``repro_torch.trace``), over the traced
calls."""
from portbench import spans


def read(record):
    calls = spans.solve_calls()
    enqueued = sum(c.counters.get("loop.enqueued", 0) for c in calls)
    if enqueued <= 0:
        return None
    useful = sum(c.counters.get("loop.iterations", 0) for c in calls)
    return 100.0 * useful / enqueued
