"""prologue_ms: the program's host time before a call's first device
work, ms: from the start of its ``solve`` span to the start of its
``contour.init`` span (``repro_torch.trace``), averaged over the traced
calls that have both."""
from portbench import spans


def read(record):
    gaps = []
    for call in spans.solve_calls():
        init = call.first("contour.init")
        if init is not None:
            gaps.append(init.start_ns - call.root.start_ns)
    if not gaps:
        return None
    return sum(gaps) / len(gaps) / 1e6
