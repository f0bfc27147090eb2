"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
reset at its start, in GiB; the resident graph counts."""


def read(record):
    if not record["peak_bytes"]:
        return None
    return record["peak_bytes"] / 2 ** 30
