"""fm_pack_s.stream: per request resolved with a permutation, seconds in
the program's ``fm:pack`` span (``core.fm.pack_fm_bucket``: each FM
bucket's lanes, keys, tiles and row extents made and checked on the
host).  None where the program opens no such span."""


def read(w):
    seconds = (getattr(w.ins, "span_s", None) or {}).get("fm:pack")
    done = sum(1 for r in w.requests if r["status"] == "ok")
    if seconds is None or not done:
        return None
    return seconds / done
