"""client_query_ms: the median host wall of client.query in the window's rounds."""

from pirbench import readers


def read(rec):
    return readers.median_wall_ms(rec, "pirbench.query")
