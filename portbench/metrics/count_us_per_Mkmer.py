"""count_us_per_Mkmer (layer: stream count; moves kmers_per_s): device time
of the stream-count kernel (``kernels/stream_count/``) in the traced
window, microseconds a million k-mers mapped."""
GROUP = "stream_count"


def read(record):
    return record.us_per_mkmer(GROUP)
