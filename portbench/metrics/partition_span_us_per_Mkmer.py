"""partition_span_us_per_Mkmer (layer: block partition; moves kmers_per_s): device time
of the operations launched inside the port's ``kmt.partition`` spans in the
traced window (``portbench/spans.py``), microseconds a million k-mers
mapped. The twin of ``partition_us_per_Mkmer``, which matches kernel names."""
from portbench import spans

SPAN = "kmt.partition"


def read(record):
    return spans.us_per_mkmer(record, SPAN)
