"""fm_step_ns.order: the FM launches' device time in the trace (every
``fm_fused_kernel``) over the move-loop steps of their critical paths, in
nanoseconds a step.  The lanes of a launch run side by side, one block
each, so a launch lasts as long as its longest lane: the program adds
that lane's step count (``steps_max``, from the kernel's own tally) to
each ``fm`` launch record of the window while it traces, and this sums
it over the launches.  So packing more or smaller lanes into a launch
moves the number only as far as the longest lane's steps get slower.
None without a device trace or without the tally."""
from orderbench import readers


def read(w):
    if w.profile is None or w.ins is None:
        return None
    kernel = sum(s for name, s in w.profile["kernel_s"].items()
                 if readers.FM_KERNEL in name)
    steps = sum(d.get("steps_max", 0) for d in w.ins.launches
                if d["kind"] == "fm")
    if kernel <= 0 or steps <= 0:
        return None
    return 1e9 * kernel / steps
