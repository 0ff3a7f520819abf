"""bench_torch.py, the port's benchmark, on the CPU at 2^10 entries
(--device cpu --log-n 10): its DB against bench.py's, every cell's
runner to a correct end with every metric named, a response corrupted in
one word caught, the sampled checks against the port's numpy oracle on
the full product, their host reference against the JAX package's encode
and PRG, the output discipline of a run in a subprocess, and the
refusals (no card, --log-n on the card, a cell not yet registered)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
import bench_torch
from chalametpir_tpu_torch import Server
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
    "ctr-2p21-a3-streaming": SERVE | {"respond_p90_ms"},
    "ctr-2p20-a3-tcp": {"server_setup_s", "client_setup_s", "serve_qps", "serve_ms", "serve_p96_ms"},
    "lo-2p23-b8": {"plane_gen_s", "respond_ms", "respond_p90_ms", "respond_batch_qps"},
    "ctr-2p16-a4": SERVE | {"respond_p95_ms", "respond_batch_qps", "restart_s"},
}
# the per-layer metrics, null on the CPU but for the setup phases and the
# TCP dispatcher's batch size
KERNELS = {
    "ctr-2p20-a3": {"k1_scan_q1", "k1_mma_q64", "k3_chunk", "ctr_fold_chunk"},
    "stream-2p20-a3": {"k1_scan_q1", "stream_fold_block"},
}
UPLOADS = {"ctr-2p20-a3": {"upload_q1_ms", "upload_q64_ms"}, "stream-2p20-a3": {"upload_q1_ms"}}


def _run(cell, seed: int):
    rec = bench_torch.run(cell, seed, "cpu", LOG_N, full_path=None)
    name = cell.name
    assert rec.correct is True, rec.full["checks"]
    assert E2E[name] <= set(rec.metrics), set(rec.metrics)
    assert all(v is not None for v, _ in rec.metrics.values())
    assert all(n == 0 for n in rec.launches.values()), rec.launches  # no kernel on the CPU
    return rec


def test_build_db_gives_bench_py_s_bytes():
    bench._db_cache.clear()
    try:
        want = bench.build_db(300, 48, np.random.default_rng(7))
    finally:
        bench._db_cache.clear()
    assert list(bench_torch.build_db(300, 48, np.random.default_rng(7)).items()) == list(want.items())


@pytest.mark.parametrize("name", ["ctr-2p20-a3", "stream-2p20-a3"])
def test_registered_cell_completes_correct(name):
    rec = _run(bench_torch.CELLS[name], 3)
    layers = {f"{k}_ms" for k in KERNELS[name]} | {f"{k}_of_bound" for k in KERNELS[name]}
    layers |= {"device_idle_share", "setup_phases_s"} | UPLOADS[name]
    assert layers <= set(rec.layers), set(rec.layers)
    for key in layers - {"setup_phases_s"}:
        assert rec.layers[key][0] is None, key  # a device metric: not measured on the CPU
    assert rec.layers["setup_phases_s"][0]
    checked = rec.full["checks"]
    assert all(checked[kind][0] > 0 and checked[kind][1] == 0 for kind in bench_torch.Checks.KINDS), checked
    assert rec.full["profile"]["window_ms"] > 0


@pytest.mark.parametrize("name", ["ctr-2p21-a3-streaming", "ctr-2p20-a3-tcp", "lo-2p23-b8", "ctr-2p16-a4"])
def test_queued_cell_completes_correct(name, monkeypatch):
    import chalametpir_tpu_torch.models.client as port_client

    cell = bench_torch.QUEUED[name]
    if cell.client_engine == "streaming":
        # every query then regenerates A through the plain Keccak: the file's longest case
        monkeypatch.setattr(port_client, "RESIDENT_PLANES_MAX_BYTES", 0)
    _run(cell, 4)


@pytest.mark.parametrize("name", sorted(bench_torch.QUEUED))
def test_cli_refuses_a_cell_not_yet_registered(name, capsys):
    assert name not in bench_torch.CELLS
    with pytest.raises(SystemExit) as exc:
        bench_torch.main(["--cell", name, "--seed", "1", *CPU])
    assert exc.value.code == 2 and capsys.readouterr().out == ""


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
