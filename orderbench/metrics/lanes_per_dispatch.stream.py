"""lanes_per_dispatch.stream: mean real lanes a dispatch of the window
(every ``obs.instrument`` launch record of the matching, band BFS and FM)."""


def read(w):
    lanes = [d["lanes"] for d in w.ins.launches
             if d["kind"] in ("match", "bfs", "fm")]
    return sum(lanes) / len(lanes) if lanes else None
