"""client_setup_s: Client.setup's seconds on the benchmark's clock, to the end of its device work
(drive.client_for)."""


def read(rec):
    return rec["counters"].get("client_setup_s")
