"""endgame_s.order: per ordering, seconds of the endgame, the batched
centralized ordering of the small subgraphs (its dispatches included)."""
from orderbench import readers


def read(w):
    return readers.per_ordering(w, w.by_kind.get("endgame", 0.0))
