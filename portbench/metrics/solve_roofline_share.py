"""solve_roofline_share: the whole call's share of the least time any
solver could take, %: every edge read once and every label written once
(``roofline.least_solve_bytes``, 8m + 4n) at the card's HBM rate, over
the calls' walls."""
from portbench import roofline


def read(record):
    walls = record["walls_s"]
    if not walls:
        return None
    need = roofline.seconds_at_peak(record["facts"]["least_bytes"])
    return 100.0 * need * len(walls) / sum(walls)
