"""respond_roofline.lookup: the respond calls' frozen least time over their kernels' device time."""

from pirbench import readers


def read(rec):
    return readers.roofline_percent(rec, "pirbench.respond")
