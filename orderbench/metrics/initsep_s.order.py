"""initsep_s.order: per ordering, seconds in the program's ``nd:initial``
span (``core.initsep.initial_parts``: the greedy-growing tries of each
coarsest graph's initial separator, on the host).  None where the program
opens no such span."""
from orderbench import readers


def read(w):
    seconds = (getattr(w.ins, "span_s", None) or {}).get("nd:initial")
    return None if seconds is None else readers.per_ordering(w, seconds)
