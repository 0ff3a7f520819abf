"""respond_roofline.serve: the respond_batch calls' frozen least time over their kernels' device time."""

from pirbench import readers


def read(rec):
    return readers.roofline_percent(rec, "pirbench.respond_batch")
