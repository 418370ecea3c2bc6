"""fm_fused_roofline.order: the FM launches' least time by bytes at the
card's HBM rate (``roofline.fm_launch_bytes``) over their device time in
the trace, in percent."""
from orderbench import readers


def read(w):
    return readers.fm_roofline_pct(w)
