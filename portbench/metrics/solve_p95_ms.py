"""solve_p95_ms: the 95th percentile (nearest rank) of every call's wall
in the window, in ms (host clock)."""
import math


def read(record):
    walls = sorted(record["walls_s"])
    if not walls:
        return None
    return 1e3 * walls[max(0, math.ceil(0.95 * len(walls)) - 1)]
