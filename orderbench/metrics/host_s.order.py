"""host_s.order: per ordering, the wall less the seconds billed to device
dispatches: the driver's host work (coarse graphs, bands, minimum degree,
the recursion, rebuilds and the endgame's host part)."""
from orderbench import readers


def read(w):
    return readers.per_ordering(w, w.wall_s - readers.dispatch_s(w))
