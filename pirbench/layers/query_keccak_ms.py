"""query_keccak_ms: device ms of the ctr Keccak kernel (K3) that the client.query spans launched, per
query (profiler): the streaming client's regeneration of A, beside client_query_device_ms's whole batch."""

from pirbench import readers

SPAN = "pirbench.query"
KERNEL = "ctr_keccak_kernel"


def read(rec):
    found = readers._assigned(rec, SPAN, lambda name: KERNEL in name)
    if found is None:
        return None
    rows, ms = found
    return sum(ms) / sum(q for _, _, q in rows) if sum(ms) else None
