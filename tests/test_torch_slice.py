"""The port's serving path end to end (chalametpir_tpu_torch.Server /
Client) against the JAX package: the same seed, DB and filter rng give
byte-identical hint and filter bytes and identical responses, and values
round-trip through the port's client. Exact equality throughout.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch

from chalametpir_tpu.errors import AcceleratorError, ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu.utils import generate_random_kv_database
from chalametpir_tpu_torch import Client, Server, convert

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)


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


@pytest.mark.parametrize("arity", [3, 4])
def test_setup_matches_jax_and_numpy(arity, rng):
    import chalametpir_tpu

    db = generate_random_kv_database(600, rng=rng, value_byte_len=(1, 96))
    seed = rng.bytes(32)
    port, hint, fparams = Server.setup(
        seed, db, arity=arity, prg_mode="ctr", rng=np.random.default_rng(7), device="cpu"
    )
    for backend in ("jax", "numpy"):
        ref, ref_hint, ref_fparams = chalametpir_tpu.Server.setup(
            seed, db, arity=arity, backend=backend, prg_mode="ctr",
            rng=np.random.default_rng(7),
        )
        assert fparams == ref_fparams
        assert hint == ref_hint  # byte-identical hint matrix
        q = _queries(port)
        assert np.array_equal(port.respond_batch(q), ref.respond_batch(q))
    assert port.setup_stats["upload_bytes"] > 0


def test_round_trip_through_port_client(rng):
    db = generate_random_kv_database(500, rng=rng, value_byte_len=(900, 1024))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, prg_mode="ctr", rng=rng, device="cpu")
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu", prepared_queries=2)
    assert client.uses_device
    keys = list(db)
    for key in keys[:4]:  # the first two come from the prepared pool
        assert client.process_response(key, server.respond(_query(client, key))) == db[key]
    batch = keys[4:9]
    for key, q in zip(batch, client.query_batch(batch)):
        assert client.process_response(key, server.respond(q)) == db[key]


def test_server_from_jax_serves_identically(rng, tmp_path):
    import chalametpir_tpu

    db = generate_random_kv_database(400, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    jax_server, _, _ = chalametpir_tpu.Server.setup(
        seed, db, backend="jax", prg_mode="ctr", rng=rng
    )
    q = _queries(jax_server, seed=2, n=4)
    want = jax_server.respond_batch(q)
    assert np.array_equal(convert.server_from_jax(jax_server, "cpu").respond_batch(q), want)
    path = str(tmp_path / "server.npz")
    jax_server.save(path)
    assert np.array_equal(convert.server_from_jax_archive(path, "cpu").respond_batch(q), want)


def test_cuda_request_without_cuda_raises(rng, monkeypatch):
    """No silent CPU fallback: without CUDA a "cuda" setup raises before
    any encode work starts."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from chalametpir_tpu.core import encode_db

    def _no_encode(*a, **k):
        raise AssertionError("setup ran on the CPU")

    monkeypatch.setattr(encode_db, "from_kv_database_streaming", _no_encode)
    monkeypatch.setattr(encode_db, "from_kv_database", _no_encode)
    db = generate_random_kv_database(50, rng=rng, value_byte_len=(1, 16))
    seed = rng.bytes(32)
    for mode in ("stream", "ctr"):
        with pytest.raises(AcceleratorError):
            Server.setup(seed, db, prg_mode=mode, device="cuda")
    with pytest.raises(AcceleratorError):
        Client.setup(seed, b"", b"", device="cuda")


@pytest.mark.cuda
def test_cuda_slice_matches_cpu(cuda):
    g = np.random.default_rng(21)
    db = generate_random_kv_database(3000, rng=g, value_byte_len=(1, 200))
    seed = g.bytes(32)
    dev, hint, fparams = Server.setup(seed, db, prg_mode="ctr", rng=np.random.default_rng(5), device=cuda)
    cpu, cpu_hint, cpu_fparams = Server.setup(
        seed, db, prg_mode="ctr", rng=np.random.default_rng(5), device="cpu"
    )
    assert (hint, fparams) == (cpu_hint, cpu_fparams)
    assert dev.planes.lo.device.type == "cuda"
    q = _queries(dev, n=5)
    assert np.array_equal(dev.respond_batch(q), cpu.respond_batch(q))
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device=cuda)
    for key in list(db)[:5]:
        assert client.process_response(key, dev.respond(_query(client, key))) == db[key]
