"""The card's peaks and the bytes a kernel launch needs: the yardstick of
the roofline metrics.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM at 3.35 TB/s.  A launch's least time is its bytes over that rate:
each input byte read once and each output byte written once, the tiles'
ids counted only up to each row's last id (what the inputs need, not
the padded width).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def fm_launch_bytes(shape, lanes: int, slots: int, row_len_numel: int) -> int:
    """Bytes of one launch of the fused FM kernel over tiles ``shape`` =
    (W, n, d) with ``lanes`` lanes and ``slots`` ids up to the rows' ends.

    Reads: the tiles' ids (int32, ``slots``), their row extents (int32),
    per lane its tile index, max moves, perturbed moves (int32 each), its
    balance slack (float32) and key (two int64 words), and per lane and
    vertex its weight (float32), part and lock (a byte each).  Writes per
    lane its part (a byte a vertex), separator weight and imbalance
    (float32 each) and its tally of three int64 counts.
    """
    _, n, _ = shape
    reads = 4 * slots + 4 * row_len_numel + lanes * (4 * 4 + 16) \
        + lanes * n * (4 + 1 + 1)
    writes = lanes * n + lanes * (4 + 4 + 24)
    return int(reads + writes)


def fm_bound_s(launches) -> float:
    """Least seconds of a list of FM launches (``Recorder`` shapes)."""
    return sum(fm_launch_bytes(d["shape"], d["lanes"], d["slots"],
                               d["row_len_numel"])
               for d in launches) / HBM_BYTES_PER_S


def bfs_launch_bytes(shape, slots: int) -> int:
    """Bytes of one call of the band BFS (``csrc/bfs_multi.cu``, either
    design) over tiles ``shape`` = (L, n, d) with ``slots`` ids up to the
    rows' ends.

    Reads: the tiles' ids (int32, ``slots``) and the source masks (int32,
    L × n).  Writes: the distances (int32, L × n).  The ping-pong buffer
    ``scratch`` is the kernel's own and not counted.
    """
    L, n, _ = shape
    return int(4 * slots + 4 * L * n + 4 * L * n)


def bfs_bound_s(launches) -> float:
    """Least seconds of a list of band BFS calls (``Recorder`` shapes)."""
    return sum(bfs_launch_bytes(d["shape"], d["slots"])
               for d in launches) / HBM_BYTES_PER_S
