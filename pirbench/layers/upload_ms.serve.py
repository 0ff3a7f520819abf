"""upload_ms.serve: device ms of the host-to-device copies in the respond_batch spans, per query."""

from pirbench import readers


def read(rec):
    return readers.upload_ms_per_query(rec, "pirbench.respond_batch")
