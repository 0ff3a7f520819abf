"""The port's stream PRG mode (the reference-interop deployment) against
the JAX package: setup (hint, filter params, plane bytes, responses), the
client engine built from the host XOF's row blocks, the frozen golden
exchange, the A-size cap, mode checks, span names, and round trips across
the two packages. Every output is an integer: the tolerance is exact
equality.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import hashlib
import io
import json
import os
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

import chalametpir_tpu.models.client as host_client
from chalametpir_tpu.core import prg
from chalametpir_tpu.errors import (
    AcceleratorError,
    ArithmeticOverflowAddingQueryIndicator,
    KVDatabaseSizeTooLarge,
)
from chalametpir_tpu.native import engine as native
from chalametpir_tpu.params import LWE_DIMENSION
from chalametpir_tpu.utils import generate_random_kv_database
from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.models import server as server_mod
from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine
from chalametpir_tpu_torch.utils import telemetry

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _query(client, key):
    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue


def _queries(server, seed=1, n=3):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, server.num_query_cols), dtype=np.uint32
    )


def _codes(g: np.random.Generator, q: int) -> np.ndarray:
    return g.integers(0, 3, size=(q, LWE_DIMENSION)).astype(np.int8)


@pytest.mark.parametrize(
    "arity,bit_len", [(3, None), (4, None), (3, 8), (3, 9), (3, 12), (3, 13)]
)
def test_stream_setup_matches_jax(arity, bit_len, rng):
    """Hint, filter params and responses equal the JAX package's jax and
    numpy backends; where its jax backend keeps the packed layout (b <=
    12), the plane bytes are equal too. At b = 13 the JAX package folds
    through digit2 planes and the port through packed ones (pack 1)."""
    import chalametpir_tpu

    db = generate_random_kv_database(500, rng=rng, value_byte_len=(1, 96))
    seed = rng.bytes(32)
    port, hint, fparams = Server.setup(
        seed, db, arity=arity, rng=np.random.default_rng(7), device="cpu",
        mat_elem_bit_len=bit_len,
    )
    q = _queries(port)
    for backend in ("jax", "numpy"):
        ref, ref_hint, ref_fparams = chalametpir_tpu.Server.setup(
            seed, db, arity=arity, backend=backend, rng=np.random.default_rng(7),
            mat_elem_bit_len=bit_len,
        )
        assert fparams == ref_fparams
        assert hint == ref_hint
        assert np.array_equal(port.respond_batch(q), ref.respond_batch(q))
        if backend == "jax" and port.mat_elem_bit_len <= 12:
            assert ref._layout == "packed"
            assert np.array_equal(port.planes.lo.numpy(), np.asarray(ref._planes.lo))
            assert (port.planes.hi is None) == (ref._planes.hi is None)
            if port.planes.hi is not None:
                assert np.array_equal(port.planes.hi.numpy(), np.asarray(ref._planes.hi))
    stats = port.setup_stats
    assert stats["a_upload_bytes"] == 4 * LWE_DIMENSION * port.num_query_cols
    assert stats["upload_bytes"] == stats["a_upload_bytes"] + port.planes.device_bytes


@pytest.mark.parametrize("block_rows", [1, 5, 128, LWE_DIMENSION])
def test_hint_does_not_depend_on_the_fold_block(block_rows, rng, monkeypatch):
    db = generate_random_kv_database(200, rng=rng, value_byte_len=(1, 40))
    seed = rng.bytes(32)
    _, want, _ = Server.setup(seed, db, rng=np.random.default_rng(3), device="cpu")
    monkeypatch.setattr(server_mod, "STREAM_BLOCK_ROWS", block_rows)
    _, got, _ = Server.setup(seed, db, rng=np.random.default_rng(3), device="cpu")
    assert got == want


def test_golden_exchange(monkeypatch):
    """The frozen exchange of tests/golden (b = 13): the port's server and
    client reproduce the hint and query SHA-256 and response.bin with the
    client secret made deterministic as tests/test_golden_interop.py does,
    and the value decodes."""
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        man = json.load(f)
    seed = bytes(range(32))
    db = {
        f"key-{i:02d}".encode(): bytes((i * 7 + j) % 256 for j in range(i + 1))
        for i in range(32)
    }
    server, hint, fparams = Server.setup(
        seed, db, arity=3, rng=np.random.default_rng(1234), device="cpu"
    )
    assert hashlib.sha256(hint).hexdigest() == man["hint_sha256"]
    with open(os.path.join(GOLDEN, "filter_params.bin"), "rb") as f:
        assert fparams == f.read()
    monkeypatch.setattr(host_client.os, "urandom", lambda n: bytes(range(n)))
    client = Client.setup(seed, hint, fparams, device="cpu")
    query = client.query(b"key-05")
    monkeypatch.undo()
    assert hashlib.sha256(query).hexdigest() == man["query_sha256"]
    response = server.respond(query)
    with open(os.path.join(GOLDEN, "response.bin"), "rb") as f:
        assert response == f.read()
    assert client.process_response(b"key-05", response) == db[b"key-05"]


@pytest.mark.parametrize("m,block_rows", [(300, 64), (1003, 7), (96, LWE_DIMENSION)])
def test_engine_from_host_rows_matches_jax_and_native(m, block_rows, rng):
    """The planes built from the XOF's row blocks give the s . A of the
    JAX package's stream-mode engine (from_host_matrix, on the CPU) and of
    the native host matvec, for any block height."""
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine as JaxEngine

    seed = rng.bytes(32)
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="stream")
    eng = DeviceQueryEngine.from_host_rows(
        prg.iter_row_blocks(LWE_DIMENSION, m, seed, block_rows, mode="stream"), m, "cpu"
    )
    codes = _codes(rng, 3)
    got = eng.matvec_batch(codes)
    assert got.shape == (3, m) and got.dtype == np.uint32
    assert np.array_equal(got, JaxEngine.from_host_matrix(a).matvec_batch(codes))
    assert np.array_equal(got, np.stack([native.ternary_matvec(c, a) for c in codes]))
    assert eng.device_bytes == 4 * (-(-m // 8) * 8) * 1776


def test_engine_from_host_rows_rejects_bad_blocks(rng):
    m = 40
    a = prg.expand_seed(LWE_DIMENSION, m, rng.bytes(32), mode="stream")
    blocks = [(r0, a[r0 : r0 + 100]) for r0 in range(0, LWE_DIMENSION, 100)]
    bad = {
        "short": blocks[:-1],
        "out of order": [blocks[1], blocks[0]] + blocks[2:],
        "wrong width": [(0, a[:100, :-1])] + blocks[1:],
    }
    for case in bad.values():
        with pytest.raises(ValueError):
            DeviceQueryEngine.from_host_rows(iter(case), m, "cpu")


def test_client_a_size_cap(rng, monkeypatch):
    """PIR_CLIENT_MAX_A_BYTES bounds the stream-mode expansion the filter
    params imply, as in the JAX client; ctr mode expands nothing on the
    host and is not bounded."""
    db = generate_random_kv_database(100, rng=rng, value_byte_len=(1, 16))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, rng=rng, device="cpu")
    a_bytes = 4 * LWE_DIMENSION * server.num_query_cols
    monkeypatch.setenv("PIR_CLIENT_MAX_A_BYTES", str(a_bytes - 1))
    with pytest.raises(KVDatabaseSizeTooLarge):
        Client.setup(seed, hint, fparams, device="cpu")
    Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
    monkeypatch.setenv("PIR_CLIENT_MAX_A_BYTES", str(a_bytes))
    client = Client.setup(seed, hint, fparams, device="cpu")
    key = next(iter(db))
    assert client.process_response(key, server.respond(_query(client, key))) == db[key]
    assert client.setup_stats["engine"] == "resident" and "a_expand_s" in client.setup_stats


@pytest.mark.parametrize("server_mode,client_mode", [("ctr", "stream"), ("stream", "ctr")])
def test_mode_mismatch_fails_closed(server_mode, client_mode, rng):
    db = generate_random_kv_database(200, rng=rng, value_byte_len=(1, 32))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, prg_mode=server_mode, rng=rng, device="cpu")
    client = Client.setup(seed, hint, fparams, prg_mode=client_mode, device="cpu")
    key = next(iter(db))
    q = _query(client, key)
    with pytest.raises(Exception):
        client.process_response(key, server.respond(q))


def test_default_mode_is_stream_as_in_jax(rng):
    """The same call with no prg_mode gives the JAX package's bytes: both
    default to stream mode, and the port's default client decodes."""
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    port = Server.setup(seed, db, rng=np.random.default_rng(11), device="cpu")
    ref = chalametpir_tpu.Server.setup(seed, db, rng=np.random.default_rng(11))
    assert port[1:] == ref[1:]
    client = Client.setup(seed, port[1], port[2], device="cpu")
    assert client._prg_mode == "stream"
    key = next(iter(db))
    assert client.process_response(key, port[0].respond(_query(client, key))) == db[key]


@pytest.mark.parametrize("mode", ["ctr ", "STREAM", ""])
def test_unknown_prg_mode_rejected(mode, rng):
    db = generate_random_kv_database(30, rng=rng, value_byte_len=(1, 16))
    seed = rng.bytes(32)
    _, hint, fparams = Server.setup(seed, db, rng=rng, device="cpu")
    with pytest.raises(ValueError, match="unknown prg mode"):
        Server.setup(seed, db, prg_mode=mode, device="cpu")
    with pytest.raises(ValueError, match="unknown prg mode"):
        Client.setup(seed, hint, fparams, prg_mode=mode, device="cpu")


def test_jax_numpy_server_with_port_client(rng):
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 200))
    seed = rng.bytes(32)
    server, hint, fparams = chalametpir_tpu.Server.setup(seed, db, backend="numpy", rng=rng)
    client = Client.setup(seed, hint, fparams, device="cpu", prepared_queries=2)
    keys = list(db)
    for key in keys[:3]:
        assert client.process_response(key, server.respond(_query(client, key))) == db[key]
    for key, q in zip(keys[3:7], client.query_batch(keys[3:7])):
        assert client.process_response(key, server.respond(q)) == db[key]


def test_port_server_with_jax_host_client(rng):
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 200))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, rng=rng, device="cpu")
    client = chalametpir_tpu.Client.setup(seed, hint, fparams, device=False)
    for key in list(db)[:4]:
        assert client.process_response(key, server.respond(_query(client, key))) == db[key]


@pytest.mark.parametrize(
    "mode,names",
    [
        ("stream", ["server_setup.encode_db", "server_setup.pack_and_upload",
                    "server_setup.hint_stream"]),
        ("ctr", ["server_setup.encode_stream", "server_setup.stream_pack_upload_fold",
                 "stream_pipeline_phases"]),
    ],
)
def test_setup_emits_the_jax_span_names(mode, names, rng):
    db = generate_random_kv_database(50, rng=rng, value_byte_len=(1, 16))
    err = io.StringIO()
    telemetry.set_trace(True)
    try:
        with redirect_stderr(err):
            Server.setup(rng.bytes(32), db, prg_mode=mode, rng=rng, device="cpu")
    finally:
        telemetry.set_trace(False)
    lines = err.getvalue().splitlines()
    for name in names:
        assert any(line.startswith(f"[trace] {name}:") for line in lines), (name, lines)


def test_cuda_requests_without_cuda_raise(rng, tmp_path):
    """No silent CPU fallback on the stream path and the archive loaders."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    db = generate_random_kv_database(50, rng=rng, value_byte_len=(1, 16))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, rng=rng, device="cpu")
    client = Client.setup(seed, hint, fparams, device="cpu")
    server.save(str(tmp_path / "server"))
    client.save(str(tmp_path / "client"))
    with pytest.raises(AcceleratorError):
        Client.setup(seed, hint, fparams, device="cuda")
    with pytest.raises(AcceleratorError):
        Server.load(str(tmp_path / "server"), device="cuda")
    with pytest.raises(AcceleratorError):
        Client.load(str(tmp_path / "client"), device="cuda")


@pytest.mark.cuda
def test_cuda_stream_setup_matches_cpu(cuda):
    g = np.random.default_rng(31)
    db = generate_random_kv_database(3000, rng=g, value_byte_len=(1, 200))
    seed = g.bytes(32)
    dev, hint, fparams = Server.setup(seed, db, rng=np.random.default_rng(5), device=cuda)
    cpu, cpu_hint, cpu_fparams = Server.setup(seed, db, rng=np.random.default_rng(5), device="cpu")
    assert (hint, fparams) == (cpu_hint, cpu_fparams)
    assert dev.planes.lo.device.type == "cuda"
    q = _queries(dev, n=5)
    assert np.array_equal(dev.respond_batch(q), cpu.respond_batch(q))
    client = Client.setup(seed, hint, fparams, device=cuda)
    assert client._engine.device.type == "cuda"
    for key in list(db)[:5]:
        assert client.process_response(key, dev.respond(_query(client, key))) == db[key]


@pytest.mark.cuda
def test_cuda_engine_from_host_rows_matches_native(cuda):
    g = np.random.default_rng(13)
    m = 20011
    seed = g.bytes(32)
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="stream")
    eng = DeviceQueryEngine.from_host_rows(
        prg.iter_row_blocks(LWE_DIMENSION, m, seed, 64, mode="stream"), m, cuda
    )
    codes = _codes(g, 5)
    assert np.array_equal(eng.matvec_batch(codes), np.stack([native.ternary_matvec(c, a) for c in codes]))
