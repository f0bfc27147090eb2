"""sweep_roofline_share: K1's share of its memory roofline, %.

Over the K1 launches that swept, the first ``iterations`` launches of
each traced call (those enqueued past the fixed point exit early and
are left out): the bytes a sweep needs (``roofline.sweep_bytes``, 8n +
8m) at the card's HBM rate, over the launches' CUDA-event time.
"""
from portbench import roofline


def read(record):
    facts = record["facts"]
    kernel = facts.get("sweep_kernel")
    if kernel is None:
        return None
    need = spent = 0.0
    for call in record["calls"]:
        sweeps = [ms for name, ms in call.get("launches", ())
                  if name == kernel][:call.get("iterations", 0)]
        need += len(sweeps) * roofline.seconds_at_peak(facts["sweep_bytes"])
        spent += sum(sweeps) / 1e3
    if spent <= 0:
        return None
    return 100.0 * need / spent
