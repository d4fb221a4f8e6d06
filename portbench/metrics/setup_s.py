"""setup_s: from the process's start to the first timed buffer: the index
load, the config, the pool, the chain-block bounds, the table's upload, one
buffer mapped, the first node_counts, two buffers mapped back to back and
the reset; in a run that compiles, the compilation. A checkout's first run
also converts the index; that build is printed apart and left out."""


def read(record):
    return record.setup_s
