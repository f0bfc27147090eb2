"""idle_share: the share of the traced calls' walls in which nothing ran
on the device, %: 1 - (the union of the profiler's device intervals
inside the calls) / (the sum of their walls), over the calls whose
marker kernel the profiler recorded.  The traced calls carry
the instruments' host cost too (a CUDA event pair a launch, a frame walk
and an event a wait), so this reads a little above an untraced call's
idle share."""


def read(record):
    busy = record.get("traced_matched_busy_s")
    walls = sum(record.get("traced_matched_walls_s") or ())
    if busy is None or walls <= 0:
        return None
    return 100.0 * (1.0 - busy / walls)
