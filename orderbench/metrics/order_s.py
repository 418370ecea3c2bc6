"""order_s: the window's wall over its completed orderings; each
ordering ends in its host permutation."""
from orderbench import readers


def read(w):
    return readers.per_ordering(w, w.wall_s)
