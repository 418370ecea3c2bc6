"""dist_s.order: per ordering, seconds of the distributed layer: the
distributed matching, BFS and halo dispatches and the host rebuilds of
distributed graphs."""
from orderbench import readers


def read(w):
    s = sum(w.by_kind.get(k, 0.0)
            for k in ("dmatch", "dbfs", "dhalo", "rebuild"))
    return readers.per_ordering(w, s)
