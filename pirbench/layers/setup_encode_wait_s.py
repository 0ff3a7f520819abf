"""setup_encode_wait_s: Server.setup's wait on the host encode (its setup_stats phases_s wait)."""


def read(rec):
    return rec["setup_phases_s"].get("wait")
