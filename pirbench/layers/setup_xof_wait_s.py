"""setup_xof_wait_s: stream-mode Server.setup's wait of its hint folds on the host XOF's producer
thread (setup_stats phases_s wait)."""


def read(rec):
    return rec["setup_phases_s"].get("wait")
