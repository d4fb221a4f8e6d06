"""upload_span_us_per_Mkmer (layer: mapper; moves kmers_per_s): device time
of the operations launched inside the port's ``kmt.upload`` spans in the
traced window (``portbench/spans.py``), microseconds a million k-mers
mapped. The twin of ``upload_us_per_Mkmer``, which matches kernel names."""
from portbench import spans

SPAN = "kmt.upload"


def read(record):
    return spans.us_per_mkmer(record, SPAN)
