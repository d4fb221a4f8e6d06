"""partition_us_per_Mkmer (layer: block partition; moves kmers_per_s):
device time of the block partition's kernels (``kernels/block_partition/``)
in the traced window, microseconds a million k-mers mapped."""
GROUP = "block_partition"


def read(record):
    return record.us_per_mkmer(GROUP)
