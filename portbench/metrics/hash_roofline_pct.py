"""hash_roofline_pct (layer: hash keys; moves kmers_per_s): the least time
of the hash-key layer's bytes at the HBM peak, as a share of its kernels'
device time in the traced window."""
GROUP = "hash_keys"


def least_bytes(buf):
    """The packed words that hold the reads, read once (the stride-padded
    rows, or the bases of the continuous layout), the reads' int32 lengths
    in the continuous layout, and each int64 key written once (a valid
    window's, and under revcomp its reverse complement's)."""
    if buf.strided:
        return 4 * buf.n_words + 8 * buf.n_keys
    return buf.n_bases / 4 + 4 * buf.n_reads + 8 * buf.n_keys


def read(record):
    return record.roofline_pct(GROUP, least_bytes)
