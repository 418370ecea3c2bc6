"""fm_s.order: per ordering, seconds of the FM refinement's dispatches
(packing the tiles, upload, the fused kernel, download)."""
from orderbench import readers


def read(w):
    return readers.per_ordering(w, w.by_kind.get("fm", 0.0))
