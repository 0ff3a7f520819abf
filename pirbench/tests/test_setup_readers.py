"""The set-up readers on synthetic records: setup_xof_wait_s reads the
set-up's wait phase; client_setup_s reads the seconds that
drive.client_for kept, and nothing where none were kept."""

from pirbench import harness

STREAM_PHASES = {"encode": 9.5, "pack_upload": 1.2, "wait": 14.0, "put": 0.8, "dispatch": 0.1, "drain": 0.0}


def reader(metric):
    return harness.Cell("stream-2p20-a3.lookup").reader(metric)


def test_setup_xof_wait_s_reads_the_wait():
    read = reader("setup_xof_wait_s")
    assert read({"setup_phases_s": STREAM_PHASES}) == 14.0
    assert read({"setup_phases_s": {}}) is None


def test_client_setup_s_reads_the_kept_seconds():
    read = reader("client_setup_s")
    assert read({"counters": {"client_setup_s": 15.2, "served": 3}}) == 15.2
    assert read({"counters": {"served": 3, "batches": 2}}) is None
