"""upload_us_per_Mkmer (layer: mapper; moves kmers_per_s): device time of
the host-to-device copies in the traced window (the kernel group
``kernels/upload/``), microseconds a million k-mers mapped."""
GROUP = "upload"


def read(record):
    return record.us_per_mkmer(GROUP)
