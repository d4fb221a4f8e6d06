"""partition_roofline_pct (layer: block partition; moves kmers_per_s): the
least time of the partition's bytes at the HBM peak, as a share of its
kernels' device time in the traced window."""
GROUP = "block_partition"
CHAIN_BLOCK = 128  # buckets a chain block


def least_bytes(buf):
    """Each int64 key read once and written once, grouped by chain block,
    and an int32 offset a chain block and one more: what the stage needs
    whatever implements it."""
    return 16 * buf.n_keys + 4 * (max(buf.n_buckets // CHAIN_BLOCK, 1) + 1)


def read(record):
    return record.roofline_pct(GROUP, least_bytes)
