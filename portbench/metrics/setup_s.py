"""setup_s: process start to window start, in s (host clock): imports,
making the graph on the device, building the program's objects, the
warm-up calls and, in a checkout's first run, nvcc."""


def read(record):
    return record["setup_s"]
