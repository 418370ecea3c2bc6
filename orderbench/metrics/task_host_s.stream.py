"""task_host_s.stream: per request resolved with a permutation, seconds
in the program's ``router:advance`` span (``service.router.WaveRouter``:
stepping the requests' task trees between waves, and each tree's first
steps at admission).  None where the program opens no such span."""


def read(w):
    seconds = (getattr(w.ins, "span_s", None) or {}).get("router:advance")
    done = sum(1 for r in w.requests if r["status"] == "ok")
    if seconds is None or not done:
        return None
    return seconds / done
