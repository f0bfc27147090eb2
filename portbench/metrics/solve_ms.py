"""solve_ms: the window's seconds over the calls it completed, in ms
(host clock; each call ends at ``synchronize()``)."""


def read(record):
    walls = record["walls_s"]
    if not walls:
        return None
    return 1e3 * record["window_s"] / len(walls)
