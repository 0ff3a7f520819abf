"""query_keccak_ms on synthetic records: the K3 events launched inside
the query spans, per query; K3 launched elsewhere and every other kernel
left out; nothing untraced or where no query span launched K3."""

import pytest

from pirbench import harness

K3 = ("(anonymous namespace)::ctr_keccak_kernel(unsigned long, unsigned long, unsigned long, unsigned long, "
      "unsigned long, long, unsigned int*)")
SCAN = "void (anonymous namespace)::respond_scan_kernel<8>(unsigned int const*, long, long, signed char const*)"
INT_MM = "void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>"


def read(rec):
    return harness.Cell("ctr-2p21-a3.lookup").reader("query_keccak_ms")(rec)


def record(device):
    # two rounds, each a query span from 0 / 1000 us, then its respond span
    spans = {"pirbench.query": [(0.0, 500.0, 1), (1000.0, 1500.0, 1)],
             "pirbench.respond": [(500.0, 600.0, 1), (1500.0, 1600.0, 1)]}
    return {"spans": spans, "device": device, "busy": None, "window_us": 2000.0}


def test_reads_the_k3_launched_in_the_query_spans_per_query():
    device = [
        (10.0, 910.0, K3, 5.0),  # launched in query 1, runs past its end: counted whole
        (100.0, 400.0, INT_MM, 50.0),  # another kernel of the query: left out
        (1100.0, 1400.0, K3, 1050.0),  # query 2
        (1200.0, 1300.0, K3, None),  # no launch given: the span it overlaps, query 2
        (550.0, 580.0, K3, 520.0),  # launched in a respond span: left out
        (1510.0, 1590.0, SCAN, 1505.0),
        (1700.0, 1800.0, K3, 1650.0),  # launched between spans: left out
    ]
    assert read(record(device)) == pytest.approx((900.0 + 300.0 + 100.0) / 1e3 / 2)


def test_reads_nothing_untraced_or_without_k3_in_a_query():
    assert read(record(None)) is None
    assert read(record([(100.0, 400.0, INT_MM, 50.0), (550.0, 580.0, K3, 520.0)])) is None
    rec = record([(10.0, 910.0, K3, 5.0)])
    del rec["spans"]["pirbench.query"]
    assert read(rec) is None
