"""setup_encode_host_s: Server.setup's host encode before the chunk pipeline (its setup_stats phases_s encode, the server_setup.encode_stream span's block)."""


def read(rec):
    return rec["setup_phases_s"].get("encode")
