"""estimate_p95_ms (end to end, host clock): the 95th percentile, by
nearest rank, of every answered request's latency in the window, from its
send to its answer on the host."""
import math


def read(ctx):
    lat = sorted(ctx["window"].latencies_s)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
