"""client_query_device_ms: device-busy ms inside the client.query spans, per query (profiler)."""

from pirbench import readers


def read(rec):
    return readers.busy_ms_per_span(rec, "pirbench.query")
