"""latency_p90_s: the 90th percentile (nearest rank) of every request's
seconds from its client's submit to its result; a request that failed or
never resolved counts as infinite (reported as 1e300)."""
import math

from orderbench import readers


def read(w):
    p = readers.nearest_rank(readers.latencies(w), 0.9)
    if p is None:
        return None
    return 1e300 if math.isinf(p) else p
