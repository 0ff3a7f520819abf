"""setup_encode_host_s on a synthetic record: the program's encode phase,
or nothing where the program does not record it."""

from pirbench import harness


def test_reads_the_encode_phase_or_nothing():
    read = harness.Cell("ctr-2p20-a3.lookup").reader("setup_encode_host_s")
    assert read({"setup_phases_s": {"encode": 1.25, "wait": 3.0}}) == 1.25
    assert read({"setup_phases_s": {"wait": 3.0}}) is None
    assert read({"setup_phases_s": {}}) is None
