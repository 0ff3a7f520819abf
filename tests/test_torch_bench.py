"""bench_torch.py, the port's benchmark, on the CPU at 2^10 entries
(--device cpu --log-n 10): its DB against bench.py's, every cell to a
correct end with every metric named, in its record and its last line, the
full-size geometry of the 2^20 arity-4, 2^22 and 2^23 cells (computed,
never built), the 2^23 cell's pack-0 chain at its full-size b = 8, a response corrupted in one word caught, a TCP connection dropped or
stalled caught, the warm-up at the cell's arity, the sampled checks
against the port's numpy oracle on the full product, their host
reference against the JAX package's encode and PRG, the output
discipline of a run in a subprocess, and the refusals (no card, --log-n
on the card, a cell that is not registered)."""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import bench
import bench_torch
from chalametpir_tpu_torch import Server, kernels
from chalametpir_tpu_torch.core import matrix_io
from chalametpir_tpu_torch.params import LWE_DIMENSION, find_mat_elem_bit_len

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_N = 10
CPU = ["--device", "cpu", "--log-n", str(LOG_N)]
# the end-to-end metrics of each cell, by name
SERVE = {"server_setup_s", "client_setup_s", "client_query_ms", "client_query_inline_ms", "respond_ms",
         "round_trip_ms"}
E2E = {
    "ctr-2p20-a3": SERVE | {"respond_p95_ms", "respond_batch_qps", "restart_s"},
    "stream-2p20-a3": SERVE | {"respond_p90_ms"},
    "stream-2p20-a3-host": SERVE | {"respond_p90_ms"},
    "ctr-2p21-a3-streaming": SERVE | {"respond_p90_ms"},
    "ctr-2p20-a3-tcp": {"server_setup_s", "client_setup_s", "serve_qps", "serve_ms", "serve_p96_ms"},
    "lo-2p23-b8": {"plane_gen_s", "respond_ms", "respond_p90_ms", "respond_batch_qps"},
    "ctr-2p16-a4": SERVE | {"respond_p95_ms", "respond_batch_qps", "restart_s"},
    "ctr-2p20-a4": SERVE | {"respond_p95_ms", "respond_batch_qps", "restart_s"},
    "ctr-2p22-a3-streaming": SERVE | {"respond_p90_ms"},
    "ctr-2p23-a3-streaming": SERVE | {"respond_p90_ms"},
}
# the per-layer metrics of each cell: the timed kernels (each as _ms and
# _of_bound) and the device's idle shares and uploads, null on the CPU;
# the host's, measured there too
CTR_KERNELS = {"k1_scan_q1", "k1_mma_q64", "k3_chunk", "ctr_fold_chunk"}
KERNELS = {
    "ctr-2p20-a3": CTR_KERNELS,
    "stream-2p20-a3": {"k1_scan_q1", "stream_fold_block"},
    "stream-2p20-a3-host": {"k1_scan_q1", "stream_fold_block"},  # the server's: the client launches nothing
    "ctr-2p21-a3-streaming": {"k1_scan_q1", "k3_chunk", "ctr_fold_chunk", "client_stream_batch"},
    "ctr-2p20-a3-tcp": set(),
    "lo-2p23-b8": {"k2_mma_q1", "k2_mma_q64"},
    "ctr-2p16-a4": CTR_KERNELS,
    "ctr-2p20-a4": CTR_KERNELS,
    "ctr-2p22-a3-streaming": {"k1_scan_q1", "k3_chunk", "ctr_fold_chunk", "client_stream_batch"},
    "ctr-2p23-a3-streaming": {"k2_mma_q1", "k3_chunk", "ctr_fold_chunk", "client_stream_batch"},
}
IN_RESPOND = {"device_idle_share", "device_idle_share_in_respond", "upload_q1_ms"}
DEVICE = {
    "ctr-2p20-a3": IN_RESPOND | {"upload_q64_ms"},
    "stream-2p20-a3": IN_RESPOND,
    "stream-2p20-a3-host": IN_RESPOND,
    "ctr-2p21-a3-streaming": IN_RESPOND,
    "ctr-2p20-a3-tcp": {"device_idle_share"},
    "lo-2p23-b8": IN_RESPOND | {"upload_q64_ms"},
    "ctr-2p16-a4": IN_RESPOND | {"upload_q64_ms"},
    "ctr-2p20-a4": IN_RESPOND | {"upload_q64_ms"},
    "ctr-2p22-a3-streaming": IN_RESPOND,
    "ctr-2p23-a3-streaming": IN_RESPOND,
}
HOST = {name: {"setup_phases_s"} for name in E2E} | {"ctr-2p20-a3-tcp": {"setup_phases_s", "serve_batch_mean"},
                                                    "stream-2p20-a3-host": {"setup_phases_s", "host_matvec_ms"},
                                                    "lo-2p23-b8": set()}
# the library call's time beside each batch row and each hint fold row
# (torch._int_mm of the queries' or A rows' digits and the lo plane)
for _name, _kernels in KERNELS.items():
    # a new set: several cells share IN_RESPOND's
    DEVICE[_name] = DEVICE[_name] | {f"{k}_int_mm_ms" for k in _kernels
                                     if k.endswith("_q64") or k in bench_torch.LIBRARY_ROWS}
# the cells' element width at 2^LOG_N entries where it is not the derived
# one: the 2^23 cell's full-size b = 8 (pack 0, K2 and no hi plane), which
# 2^10 entries would not derive (b = 12)
CPU_B = {"ctr-2p23-a3-streaming": 8}


def _run(cell, seed: int):
    rec = bench_torch.run(cell, seed, "cpu", LOG_N, full_path=None)
    name = cell.name
    assert rec.correct is True, rec.full["checks"]
    assert E2E[name] <= set(rec.metrics), set(rec.metrics)
    assert all(v is not None for v, _ in rec.metrics.values())
    assert all(n == 0 for n in rec.launches.values()), rec.launches  # no kernel on the CPU
    return rec


def test_host_cell_runs_the_jax_host_engine(records):
    """stream-2p20-a3-host is stream-2p20-a3 with bench.py's interop client,
    Client.setup(device=False): the host engine (A in host memory, s.A by
    the native ternary matvec, prepare_stats' host_matvec_s), correct at
    2^10 entries, with no client kernel row."""
    host, stream = bench_torch.CELLS["stream-2p20-a3-host"], bench_torch.CELLS["stream-2p20-a3"]
    assert host == dataclasses.replace(stream, name=host.name, why=host.why, source=host.source,
                                       client_engine="host")
    assert "bench.py:1431-1442" in host.source and "client_device=False" in host.source
    rec = _record(records, host.name)
    stats = rec.full["client_setup_stats"]
    assert stats["engine"] == "host" and stats["plane_bytes"] == 0
    assert {"a_expand_s", "alloc_s", "xof_s", "wall_s", "cpu_s", "sys_s", "minflt"} <= set(stats)
    prep = rec.full["client_prepare_stats"]
    assert "host_matvec_s" in prep and "readback_s" not in prep and prep["count"] == bench_torch.POOL
    assert rec.layers["host_matvec_ms"][0] == pytest.approx(prep["host_matvec_s"] / prep["count"] * 1e3)
    assert not any(name.startswith("client_") for name in rec.full["kernels"])
    assert rec.full["host_client_card_use"] == {"launches": 0, "allocations": 0}


def test_host_client_card_use_makes_the_run_incorrect(monkeypatch):
    """A kernel launched or a card allocation made inside a host client's
    call is counted and makes the run incorrect; a device client's calls,
    and calls on the CPU, are not counted."""
    uses = iter([(5, 7), (6, 7), (6, 7), (6, 9)])
    monkeypatch.setattr(bench_torch, "card_use", lambda dev: next(uses))
    card, cpu = types.SimpleNamespace(type="cuda"), types.SimpleNamespace(type="cpu")
    checks = bench_torch.Checks()
    for kind in checks.KINDS:
        checks.count(kind, True)
    for host, dev in ((False, card), (True, cpu)):
        with checks.card_use_of(host, dev):
            pass
    assert checks.correct(checks.KINDS)
    with checks.card_use_of(True, card):
        pass
    assert checks.host_card_use == {"launches": 1, "allocations": 0} and not checks.correct(checks.KINDS)
    with checks.card_use_of(True, card):
        pass
    assert checks.host_card_use == {"launches": 1, "allocations": 2}


def test_build_db_gives_bench_py_s_bytes():
    bench._db_cache.clear()
    try:
        want = bench.build_db(300, 48, np.random.default_rng(7))
    finally:
        bench._db_cache.clear()
    assert list(bench_torch.build_db(300, 48, np.random.default_rng(7)).items()) == list(want.items())


@pytest.fixture(scope="module")
def records() -> dict:
    """Each cell's record, run once for the tests of this file that read it."""
    return {}


def _record(records: dict, name: str):
    import chalametpir_tpu_torch.models.client as port_client

    if name not in records:
        cell = bench_torch.CELLS[name]
        if name in CPU_B:
            cell = dataclasses.replace(cell, b=CPU_B[name])
        with pytest.MonkeyPatch.context() as patch:
            if cell.client_engine == "streaming":
                # every query then regenerates A through the plain Keccak: the file's longest case
                patch.setattr(port_client, "RESIDENT_PLANES_MAX_BYTES", 0)
            records[name] = _run(cell, 3)
    return records[name]


def test_every_cell_is_registered_with_a_source():
    assert set(bench_torch.CELLS) == set(E2E)
    assert all(0 < len(cell.source) <= 200 for cell in bench_torch.CELLS.values())


@pytest.mark.parametrize("name", sorted(E2E))
def test_registered_cell_completes_correct(name, records):
    rec = _record(records, name)
    device = {f"{k}_ms" for k in KERNELS[name]} | {f"{k}_of_bound" for k in KERNELS[name]} | DEVICE[name]
    assert device | HOST[name] <= set(rec.layers), set(rec.layers)
    for key in device:
        assert rec.layers[key][0] is None, key  # a device metric: not measured on the CPU
    for key in HOST[name]:
        assert rec.layers[key][0], key
    checked = rec.full["checks"]
    kinds = ("columns", "batch_vs_single") if name == "lo-2p23-b8" else bench_torch.Checks.KINDS
    assert all(checked[kind][0] > 0 and checked[kind][1] == 0 for kind in kinds), checked
    assert rec.full["profile"]["window_ms"] > 0
    assert rec.full["query_retries"] >= 0 and rec.full["peak_rss_GB"] > 0


@pytest.mark.parametrize("name", sorted(E2E))
def test_last_line_holds_the_cells_metrics(name, records):
    """The run's last line names every end-to-end metric of the cell (PERF.md
    section 4), each with a value and a unit, and every per-layer one."""
    rec = _record(records, name)
    last = json.loads(rec.line("done"))
    assert last["cell"] == name and last["phase"] == "done" and last["correct"] is True
    assert E2E[name] <= set(last["metrics"]), set(last["metrics"])
    assert all(value is not None and unit for value, unit in last["metrics"].values())
    assert set(last["layers"]) == set(rec.layers)
    assert set(last["launches"]) == set(kernels.LAUNCHES)


# each cell of bench.py's 2^20 arity-4 row and scaling points at its full
# size: (arity, log2 entries, m, engine, closed-loop responds, batches,
# restart), (b, c, c_pad, pack, plane GB, A GB, ctr setup chunks, whether
# the streaming client's fused s.A kernel reads ctr words past 2^32)
FULL_SIZE = {
    "ctr-2p20-a4": ((4, 20, 1_130_496, "resident", 200, 20, True), (9, 940, 1024, 8, 1.30, 8.02, 9, None)),
    "ctr-2p22-a3-streaming": ((3, 22, 4_718_592, "streaming", 100, 0, False), (9, 940, 1024, 8, 5.44, 33.48, 36, True)),
    "ctr-2p23-a3-streaming": ((3, 23, 9_437_184, "streaming", 100, 0, False),
                              (8, 1057, 1152, 0, 10.87, 66.97, 72, True)),
}


@pytest.mark.parametrize("name", sorted(FULL_SIZE))
def test_cell_holds_its_full_size_geometry(name):
    """The cell's fields, and the geometry its full-size DB gets, computed
    without building it: m (the reference's query is 8 + 4m bytes), its
    own b, c in c_pad padded columns, the pack (0: a lo plane alone), the
    planes' bytes, whether the last ctr fold chunk's view starts past 2^32
    bytes, the side of RESIDENT_PLANES_MAX_BYTES that the client's A falls
    on, the setup's fold chunks and, for a streaming client, whether its
    last fingerprint column starts past 2^32 words of the ctr stream (the
    fused kernel's 64-bit word index)."""
    from chalametpir_tpu_torch.core import codec
    from chalametpir_tpu_torch.core.filter import filter_geometry
    from chalametpir_tpu_torch.models import client as port_client
    from chalametpir_tpu_torch.models.server import _ctr_chunk_cols
    from chalametpir_tpu_torch.ops.respond_packed import LANE, M_ALIGN, pack_geometry

    (arity, log_n, m, engine, responds, batches, restart), (b, c, c_pad, pack, planes_gb, a_gb, chunks, past_2p32_words) = (
        FULL_SIZE[name])
    cell = bench_torch.CELLS[name]
    assert (cell.arity, cell.log_n, cell.client_engine, cell.responds, cell.batches, cell.restart) == (
        arity, log_n, engine, responds, batches, restart)
    assert (cell.prg_mode, cell.traffic, cell.value_len, cell.b) == ("ctr", "serve", 1024, None)
    assert filter_geometry(arity, 1 << log_n)[2] == m
    assert find_mat_elem_bit_len(1 << log_n) == b
    assert codec.encoded_row_width(cell.value_len, b) == c and -(-c // LANE) * LANE == c_pad
    got_pack, _, pc = pack_geometry(b, c_pad)
    m_pad = -(-m // M_ALIGN) * M_ALIGN
    lo_bytes = m_pad * c_pad
    assert got_pack == pack and (lo_bytes + (m_pad * pc if pack else 0)) / 1e9 == pytest.approx(planes_gb, abs=0.01)
    cc = _ctr_chunk_cols(m, M_ALIGN)
    assert -(-m // cc) == chunks
    # the last fold chunk's view, and so every row past it, lies past 2^32 bytes of the lo plane
    assert ((m_pad - cc) * c_pad > 1 << 32) == (log_n >= 22)
    a_bytes = 4 * m * LWE_DIMENSION
    assert (a_bytes > port_client.RESIDENT_PLANES_MAX_BYTES) == (engine == "streaming")
    assert port_client.uses_streaming(m) == (engine == "streaming")
    assert a_bytes / 1e9 == pytest.approx(a_gb, abs=0.01)
    if past_2p32_words is not None:
        assert ((-(-m // 8) * 8 - 1) * LWE_DIMENSION >= 1 << 32) == past_2p32_words


def test_2p23_cell_runs_the_pack0_chain(records):
    """ctr-2p23-a3-streaming at 2^10 entries and its full-size b = 8: the
    server's planes are a lo plane alone (so its ctr fold and respond are
    K2's work), the client streams A (RESIDENT_PLANES_MAX_BYTES patched to
    0), and every check passes, the hint's against the host PRG included."""
    rec = _record(records, "ctr-2p23-a3-streaming")
    geo = rec.full["geometry"]
    assert (geo["b"], geo["hi_plane"]) == (8, False) and geo["plane_bytes"] == geo["m_pad"] * geo["c_pad"]
    assert rec.full["client_setup_stats"]["engine"] == "streaming"
    assert rec.full["checks"]["hint"] == [bench_torch.SAMPLED_HINT, 0]
    assert {"k2_mma_q1", "ctr_fold_chunk", "client_stream_batch"} <= set(rec.full["kernels"])
    assert rec.full["server_setup_launches"] == {}  # the CPU runs the plain versions


@pytest.mark.parametrize("name", ["ctr-2p22-a3", "CTR-2P20-A3", ""])
def test_cli_refuses_an_unknown_cell(name, capsys):
    with pytest.raises(SystemExit) as exc:
        bench_torch.main(["--cell", name, "--seed", "1", *CPU])
    assert exc.value.code == 2 and capsys.readouterr().out == ""


def test_warm_up_runs_at_the_cells_arity(monkeypatch):
    """The first arity-4 setup is the warm-up's, not the timed one's."""
    arities = []
    original = Server.setup.__func__

    def spy(cls, *args, **kwargs):
        arities.append(kwargs["arity"])
        return original(cls, *args, **kwargs)

    monkeypatch.setattr(Server, "setup", classmethod(spy))
    bench_torch.warm_up("ctr", 4, 1 << 8, torch.device("cpu"), bench_torch.Checks())
    assert arities == [4]


@pytest.mark.parametrize("fault", ["dropped", "stalled"])
def test_tcp_fault_ends_the_run_incorrect(fault, monkeypatch, capsys):
    """A query the server drops its connection over, or one whose answer
    never comes, in the timed window: the run ends within the phase limit,
    exit 1, its last line `correct` false."""
    from chalametpir_tpu_torch.errors import ChalametPIRError
    from chalametpir_tpu_torch.net.server import BatchDispatcher

    original = BatchDispatcher.submit
    calls = []

    async def faulty(self, query_bytes):
        calls.append(len(query_bytes))
        if len(calls) == 2 * bench_torch.TCP_CONNS + 8:
            if fault == "dropped":
                raise ChalametPIRError("dropped")
            await asyncio.Event().wait()
        return await original(self, query_bytes)

    monkeypatch.setattr(BatchDispatcher, "submit", faulty)
    monkeypatch.setattr(bench_torch, "TCP_TIMEOUT_S", 5.0)
    t0 = time.perf_counter()
    assert bench_torch.main(["--cell", "ctr-2p20-a3-tcp", "--seed", "5", *CPU]) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["correct"] is False and last["phase"] == "failed"
    assert time.perf_counter() - t0 < 60


def test_corrupted_response_word_makes_the_run_incorrect(monkeypatch, capsys):
    """One word of one response, flipped in its top bit: correct false,
    exit code 1."""
    original = Server.respond_batch
    calls = []

    def corrupt(self, queries):
        out = original(self, queries)
        calls.append(len(queries))
        if len(calls) == 40:
            out = out.copy()
            out[0, 0] ^= np.uint32(1 << 31)
        return out

    monkeypatch.setattr(Server, "respond_batch", corrupt)
    assert bench_torch.main(["--cell", "ctr-2p20-a3", "--seed", "5", *CPU]) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["correct"] is False and last["phase"] == "done"
    assert len(calls) > 40


@pytest.mark.parametrize("mode", ["ctr", "stream"])
def test_sampled_checks_agree_with_the_numpy_oracle(mode):
    """The host reference of the checks (D's columns from the host encode,
    A's rows from the host PRG, uint64 products) equals the port's numpy
    oracle on every column of the responses and on 64 rows of the hint,
    and the checks count a wrong word."""
    db = bench_torch.build_db(1 << LOG_N, 1024, np.random.default_rng(8))
    seed = bytes(range(32))
    oracle, hint, fparams = Server.setup(seed, db, 3, "numpy", prg_mode=mode, rng=bench_torch.stream_of(8, bench_torch.SETUP))
    m, c, b = oracle.num_query_cols, oracle.num_response_cols, oracle.mat_elem_bit_len
    cols = np.arange(c)
    d_cols = bench_torch.host_d_columns(db, 3, b, bench_torch.stream_of(8, bench_torch.SETUP), fparams, cols)
    assert bench_torch.host_d_columns(db, 3, b, bench_torch.stream_of(9, bench_torch.SETUP), fparams, cols) is None
    queries = np.random.default_rng(1).integers(0, 1 << 32, size=(6, m), dtype=np.uint32)
    responses = oracle.respond_batch(queries)
    assert np.array_equal(bench_torch.column_product(queries, d_cols), responses)
    a = bench_torch.host_a_rows(seed, m, np.arange(LWE_DIMENSION), mode)
    rows = np.random.default_rng(3).choice(LWE_DIMENSION, size=64, replace=False)  # the oracle's product costs ~10 s
    assert np.array_equal(bench_torch.column_product(a[rows], d_cols), matrix_io.matrix_from_bytes(hint)[rows])
    assert np.array_equal(bench_torch.host_a_rows(seed, m, rows, mode), a[rows])
    checks = bench_torch.Checks()
    kept = [(q, r.copy()) for q, r in zip(queries, responses)]
    kept[2][1][c - 1] += np.uint32(1)
    bench_torch.check_columns(kept, d_cols, cols, checks)
    hint_m = matrix_io.matrix_from_bytes(hint).copy()
    bench_torch.check_hint(hint_m, seed, d_cols, cols, mode, np.random.default_rng(2), checks)
    assert checks.counts["columns"] == [6, 1] and checks.counts["hint"] == [bench_torch.SAMPLED_HINT, 0]


@pytest.mark.parametrize("mode", ["ctr", "stream"])
def test_host_reference_equals_the_jax_package(mode):
    """The checks' D (the port's host encode) and A's rows (the port's host
    PRG) equal the JAX package's encode and PRG on the same seed, so a
    fault in the host code that the port's server, client and checks share
    cannot pass the checks."""
    from chalametpir_tpu.core import encode_db as jax_encode_db
    from chalametpir_tpu.core import prg as jax_prg

    db = bench_torch.build_db(1 << LOG_N, 1024, np.random.default_rng(11))
    b = find_mat_elem_bit_len(len(db))
    mat_d, filt = jax_encode_db.from_kv_database(db, 3, b, rng=bench_torch.stream_of(11, bench_torch.SETUP))
    cols = np.arange(mat_d.shape[1])
    d_cols = bench_torch.host_d_columns(db, 3, b, bench_torch.stream_of(11, bench_torch.SETUP), filt.to_bytes(),
                                        cols)
    assert d_cols is not None and np.array_equal(d_cols.astype(np.uint32), mat_d.astype(np.uint32))
    seed, m = bytes(range(32, 64)), mat_d.shape[0]
    rows = np.append(np.random.default_rng(5).choice(LWE_DIMENSION - 1, size=15, replace=False), LWE_DIMENSION - 1)
    want = jax_prg.expand_seed(LWE_DIMENSION, m, seed, mode=mode)
    assert np.array_equal(bench_torch.host_a_rows(seed, m, rows, mode), want[rows])


def test_synthetic_lo_plane_is_the_hash_the_host_computes():
    """The lo cell's plane, filled by torch in row slabs, holds
    plane_value(seed, i, j) + the bias and zero-valued padding; numpy's
    int64 plane_value equals the exact integer one at the largest indices
    a cell reaches."""
    m, cols = (1 << 16) + 4464, 8  # two slabs
    planes = bench_torch.synthetic_lo_plane(7, m, cols, 8, "cpu")
    lo = planes.lo.numpy()
    want = bench_torch.plane_value(7, np.arange(m, dtype=np.int64)[:, None], np.arange(cols, dtype=np.int64)[None, :])
    assert lo.shape == (71680, 128) and planes.hi is None and planes.num_rows == m
    assert np.array_equal(lo[:m, :cols].astype(np.int16) + 128, want)
    assert (lo[m:] == -128).all() and (lo[:, cols:] == -128).all()
    assert len(np.unique(want)) == 256
    seed, i, j = (1 << 40) + 3, np.array([[0], [1 << 23], [(1 << 24) - 1]]), np.array([[0, 1039, 2047]])
    exact = [[bench_torch.plane_value(seed, int(r), int(c)) for c in j[0]] for r in i[:, 0]]
    assert np.array_equal(bench_torch.plane_value(seed, i.astype(np.int64), j.astype(np.int64)), exact)


def test_copy_ms_by_span_gives_each_span_the_copies_it_started():
    spans = [(0, 10, "bench.query"), (10, 14, "bench.respond"), (20, 30, "bench.respond")]
    copies = [(1, 3), (11, 12), (13, 16), (25, 26), (40, 41)]
    assert bench_torch.copy_ms_by_span(spans, copies) == pytest.approx(
        {"bench.query": [2e-3], "bench.respond": [4e-3, 1e-3]})


def test_copy_ms_by_span_keeps_a_copy_that_reads_as_starting_before_its_span():
    """The lo cell's trace on the card: a batch's upload starts within
    microseconds of its span, and on the device's clock two of four read as
    starting before it; each is still its span's."""
    spans = [(100 + 400 * i, 480 + 400 * i, "bench.respond_batch") for i in range(4)]
    copies = [(99.5, 470), (500.2, 875), (899, 1270), (1300.1, 1670)]
    got = bench_torch.copy_ms_by_span(spans, copies)["bench.respond_batch"]
    assert got == pytest.approx([(c1 - c0) / 1e3 for c0, c1 in copies])


@pytest.mark.parametrize("n,p", [(200, 95), (100, 90), (256, 96)])
def test_tail_has_ten_samples_beyond_it(n, p):
    samples = list(np.random.default_rng(n).permutation(n).astype(float))
    got_p, value = bench_torch.tail(samples)
    assert got_p == p and sum(s > value for s in samples) == bench_torch.TAIL_BEYOND


def test_idle_breakdown_splits_the_device_gaps_over_the_spans():
    """The profile reader's arithmetic (the card's timeline is read only on
    the card): intervals merged and clipped to the window, each gap's time
    split over the spans it crosses."""
    spans = [(0, 10, "bench.query"), (10, 14, "bench.respond"), (15, 20, "bench.process_response")]
    out = bench_torch.idle_breakdown(spans, [(2, 5), (4, 8), (11, 12), (25, 30)])
    assert out["device_idle_share"] == pytest.approx(13 / 20)
    assert out["respond_idle_share"] == pytest.approx(3 / 4)
    assert out["idle_ms_by_span"] == pytest.approx(
        {"bench.query": 4e-3, "bench.respond": 3e-3, "between spans": 1e-3, "bench.process_response": 5e-3})
    assert [(g["ms"], g["span"]) for g in out["longest_idle_gaps"]] == pytest.approx(
        [(8e-3, "bench.process_response"), (3e-3, "bench.query"), (2e-3, "bench.query")])


def test_run_in_a_subprocess_prints_only_compact_json_lines():
    proc = subprocess.run([sys.executable, "bench_torch.py", "--cell", "stream-2p20-a3", "--seed", "6", *CPU],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    records = [json.loads(line) for line in lines]
    assert all(len(line.encode()) <= bench_torch.MAX_LINE for line in lines)
    assert records[0]["card"] == "cpu" and records[0]["kind"] == "cpu"
    last = records[-1]
    assert last["correct"] is True and last["phase"] == "done"
    assert E2E["stream-2p20-a3"] <= set(last["metrics"])
    assert all(unit for _, unit in last["metrics"].values())
    assert {"k1_scan_q1_ms", "stream_fold_block_ms", "device_idle_share"} <= set(last["layers"])
    full = os.path.join(ROOT, last["full"])
    with open(full) as f:
        assert json.load(f)["respond_samples_s"]
    os.remove(full)


@pytest.mark.parametrize("argv", [[], ["--log-n", "10"]], ids=["no-card", "log-n-on-the-card"])
def test_refusals_run_no_phase(argv):
    """Without a card and without --device cpu (the card hidden, were there
    one), and --log-n on the card: a non-zero exit before any record."""
    proc = subprocess.run([sys.executable, "bench_torch.py", "--cell", "ctr-2p20-a3", "--seed", "1", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout
