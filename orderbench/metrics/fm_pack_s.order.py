"""fm_pack_s.order: per ordering, seconds in the program's ``fm:pack``
span (``core.fm.pack_fm_bucket``: each FM bucket's lanes, keys, tiles and
row extents made and checked on the host), a part of ``fm_s.order``.
None where the program opens no such span."""
from orderbench import readers


def read(w):
    seconds = (getattr(w.ins, "span_s", None) or {}).get("fm:pack")
    return None if seconds is None else readers.per_ordering(w, seconds)
