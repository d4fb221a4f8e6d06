"""kmers_per_s: every k-mer (valid window) that ``map_chunk`` folded into
the counts in the window, over the window's host-clock seconds (to the end
of its synchronize), in millions."""


def read(record):
    return record.kmers / record.window_s / 1e6
