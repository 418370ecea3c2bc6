"""queue_wait_p50_s.stream: the median seconds a resolved request
waited in the service's admission queues (``OrderResult.queue_wait_s``)."""
from orderbench import readers


def read(w):
    waits = [r["queue_wait_s"] for r in w.requests if r["status"] == "ok"
             and r["queue_wait_s"] is not None and not r["cached"]]
    return readers.nearest_rank(waits, 0.5)
