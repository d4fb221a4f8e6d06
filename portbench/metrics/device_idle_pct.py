"""device_idle_pct (layer: device; moves kmers_per_s): the share of the
traced window in which no kernel, copy or set ran on the card."""


def read(record):
    trace = record.trace
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
