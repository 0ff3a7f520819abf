"""The benchmark's 4-wise deployment, ctr-2p18-a4 (pirbench/configs), on the
CPU: its lookup cell run through the harness at 2^10 entries against the
plain reference, its float32 control read wrong, and the geometry its
configuration states held against the port's derivation at full size,
computed without building anything."""

import json
import os

import pytest

from chalametpir_tpu_torch import kernels, params
from chalametpir_tpu_torch.core import codec
from chalametpir_tpu_torch.core.filter import filter_geometry
from chalametpir_tpu_torch.models import client as port_client
from chalametpir_tpu_torch.ops.packed import hi_pack_factor
from pirbench import harness, workcount

CELL = "ctr-2p18-a4.lookup"
CONFIG = os.path.join(harness.ROOT, "pirbench", "configs", "ctr-2p18-a4.json")
SEED = 2**33 + 2_718_281


@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_the_cell_is_checked_against_the_plain_reference(control):
    result = harness.run(CELL, SEED, 1.0, False, device="cpu", log_n=10, control=control)
    checks = result["checks"]
    if control:
        assert result["correct"] is False
        assert checks["hint_words_wrong"]["value"] > 0 and checks["response_words_wrong"]["value"] > 0
    else:
        assert result["correct"] is True, checks
        assert all(c["value"] == 0 for c in checks.values())
        warm = harness.Cell(CELL).mix["warm_rounds"]
        assert checks["values_wrong"]["compared"] == result["attempted"] + warm
        assert set(result["metrics"]) == {"round_trip_ms", "round_trip_p95_ms", "setup_s"}


def test_the_configuration_states_the_ports_full_size_geometry():
    cfg = json.load(open(CONFIG))
    assert (cfg["arity"], cfg["prg_mode"], cfg["reduced"]) == (4, "ctr", [])
    n = 1 << cfg["log_n"]
    b = cfg["b"] or params.find_mat_elem_bit_len(n)
    m = filter_geometry(cfg["arity"], n)[2]
    c = codec.encoded_row_width(cfg["value_len"], b)
    assert (b, m, c) == (10, 288_768, 846)
    assert "m = 288,768" in cfg["deployment"] and "c = 846" in cfg["deployment"]
    planes = workcount.plane_geometry(m, c, b)
    assert planes["plane_bytes"] == 323_420_160 and "323 MB" in cfg["deployment"]
    # a 2-bit hi plane, 4 values a byte: K1 scans at Q = 1 with pack 4, where
    # every other cell's b = 9 planes scan at pack 8
    assert hi_pack_factor(b) == 4 and kernels.choose_regime(1, 4) == "scan"
    a_bytes = 4 * m * params.LWE_DIMENSION
    assert a_bytes / 1e9 == pytest.approx(2.05, abs=0.005) and "2.05 GB" in cfg["deployment"]
    assert not port_client.uses_streaming(m) and cfg["client_engine"] == "resident"

