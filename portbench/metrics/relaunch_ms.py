"""relaunch_ms: the program's host time from each read of a device value
to its next kernel launch, ms a call: over a call's ``read.*`` spans
(``repro_torch.trace``), the start of the first ``launch.*`` span after
the read's end less that end (nothing where no launch follows), summed
a call and averaged over the traced calls.  The device has drained at
each read and idles until the launch; a torch op enqueued before the
launch (the sweep's copy of the labels) counts in."""
import bisect

from portbench import spans


def read(record):
    calls = spans.solve_calls()
    if not calls:
        return None
    total = 0
    for call in calls:
        launches = sorted(s.start_ns for s in call.named("launch."))
        for r in call.named("read."):
            i = bisect.bisect_left(launches, r.end_ns)
            if i < len(launches):
                total += launches[i] - r.end_ns
    return total / len(calls) / 1e6
