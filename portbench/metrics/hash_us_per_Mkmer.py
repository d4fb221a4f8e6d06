"""hash_us_per_Mkmer (layer: hash keys; moves kmers_per_s): device time of
the hash-key kernels (``kernels/hash_keys/``) in the traced window,
microseconds a million k-mers mapped."""
GROUP = "hash_keys"


def read(record):
    return record.us_per_mkmer(GROUP)
