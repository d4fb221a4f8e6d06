"""count_roofline_pct (layer: stream count; moves kmers_per_s): the least
time of the count's bytes at the HBM peak, as a share of its kernel's
device time in the traced window."""
GROUP = "stream_count"
SLOT_BYTES = 8  # a slot's two uint32 key words


def least_bytes(buf):
    """Each int64 key read once (two a window under revcomp); the whole
    table read once, since every chain block gets keys (hundreds a block in
    every cell); a slot's count read and written where a key hits it."""
    return 8 * buf.n_keys + buf.n_buckets * 8 * SLOT_BYTES + 8 * buf.distinct_hits


def read(record):
    return record.roofline_pct(GROUP, least_bytes)
