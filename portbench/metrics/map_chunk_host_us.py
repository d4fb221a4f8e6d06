"""map_chunk_host_us (layer: mapper; moves kmers_per_s): the host's own
time in a ``map_chunk`` call of the traced window: each call's region in
the profiler's trace less the CUDA runtime calls inside it (launches and
copies, where the host waits for room in the device's queue once it is a
queue ahead), microseconds a call, the profiler's own cost included. It
moves kmers_per_s only where the host paces the card."""
REGION = "map_chunk"


def read(record):
    if record.trace is None:
        return None
    seconds, calls = record.trace.host_self_s(REGION)
    return seconds / calls * 1e6 if calls else None
