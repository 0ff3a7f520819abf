"""device_idle_share.lookup: the share of the window in which the device ran nothing (profiler)."""

from pirbench import readers


def read(rec):
    return readers.idle_percent(rec)
