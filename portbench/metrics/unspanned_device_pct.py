"""unspanned_device_pct (layer: device; moves kmers_per_s): the share of the
traced window's device time whose operations were launched outside every
stage span of the port (``portbench/spans.py``): work that no stage's
metric reads."""
from portbench import spans


def read(record):
    got = spans.credit(record.trace)
    return None if got is None else 100.0 * got.share(spans.UNSPANNED)
