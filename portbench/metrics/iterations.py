"""iterations: the Contour loop's iterations a call, from
``ComponentResult.iterations``, averaged over the traced calls."""


def read(record):
    its = [c["iterations"] for c in record["calls"] if "iterations" in c]
    if not its:
        return None
    return sum(its) / len(its)
