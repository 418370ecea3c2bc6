"""orderings_per_s: requests resolved with a permutation in the window,
over the window's time up to the last of them.

The window ends, as a one-client cell's does, with its last result: the
requests that resolved before the close, over the seconds from the start
to the last of those resolutions.  The service resolves requests in
bursts (a wave finishes many), so a fixed close would count a burst or
not by chance."""


def read(w):
    done = [r["t_done"] - w.t0 for r in w.requests if r["status"] == "ok"
            and r["t_done"] is not None and r["t_done"] - w.t0 <= w.wall_s]
    if not done or max(done) <= 0:
        return None
    return len(done) / max(done)
