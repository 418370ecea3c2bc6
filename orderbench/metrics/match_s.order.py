"""match_s.order: per ordering, seconds of the centralized matching's
dispatches (packing, upload, kernel, download)."""
from orderbench import readers


def read(w):
    return readers.per_ordering(w, w.by_kind.get("match", 0.0))
