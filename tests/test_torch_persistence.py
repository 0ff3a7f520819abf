"""Save and load in the port, and across the port and the JAX package:
server archives in both directions (the port writes the JAX package's
archive layouts and reads its packed, numpy and digit2 archives), paths
without a suffix, and client archives with pending queries in both PRG
modes. Responses are compared for exact equality.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Client, Server, convert
from chalametpir_tpu_torch.errors import ArithmeticOverflowAddingQueryIndicator, PendingQueryExistsForKey
from chalametpir_tpu_torch.params import find_mat_elem_bit_len
from chalametpir_tpu_torch.utils import generate_random_kv_database

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _query(client, key, overflow=ArithmeticOverflowAddingQueryIndicator):
    """client.query, retried on the indicator overflow (`overflow`: the
    exception class of the client's package)."""
    while True:
        try:
            return client.query(key)
        except overflow:
            continue


def _queries(server, seed=1, n=4):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, server.num_query_cols), dtype=np.uint32
    )


# entries of each case's DB: 300, except where a forced width needs fewer.
# A width past the bound of FrodoPIR's eq. 8 for the DB's size
# (find_mat_elem_bit_len: 12 at 300 entries, 13 at 64) lets the client's
# error, drawn from OS randomness and not from `rng`, pass the decode's
# margin now and then; 64 entries keep b = 13 within it.
ENTRIES = {13: 64}


@pytest.mark.parametrize("mode,bit_len", [("stream", None), ("ctr", None), ("stream", 8), ("stream", 13)])
def test_port_save_port_load(mode, bit_len, rng, tmp_path):
    db = generate_random_kv_database(ENTRIES.get(bit_len, 300), rng=rng, value_byte_len=(1, 64))
    assert bit_len is None or find_mat_elem_bit_len(len(db)) >= bit_len
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, prg_mode=mode, rng=rng, device="cpu", mat_elem_bit_len=bit_len
    )
    path = str(tmp_path / "server.npz")
    server.save(path)
    loaded = Server.load(path, device="cpu")
    assert torch.equal(loaded.planes.lo, server.planes.lo)
    assert (loaded.planes.hi is None) == (server.planes.hi is None)
    if server.planes.hi is not None:
        assert torch.equal(loaded.planes.hi, server.planes.hi)
    q = _queries(server)
    assert np.array_equal(loaded.respond_batch(q), server.respond_batch(q))
    client = Client.setup(seed, hint, fparams, prg_mode=mode, device="cpu")
    key = next(iter(db))
    assert client.process_response(key, loaded.respond(_query(client, key))) == db[key]


@pytest.mark.parametrize("mode", ["stream", "ctr"])
def test_port_archive_loads_in_jax(mode, rng, tmp_path):
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server, _, _ = Server.setup(seed, db, prg_mode=mode, rng=rng, device="cpu")
    path = str(tmp_path / "server.npz")
    server.save(path)
    jax_server = chalametpir_tpu.Server.load(path)
    assert (jax_server._backend, jax_server._layout) == ("jax", "packed")
    q = _queries(server)
    assert np.array_equal(jax_server.respond_batch(q), server.respond_batch(q))


@pytest.mark.parametrize(
    "backend,layout,bit_len",
    [("jax", "packed", None), ("numpy", "auto", None), ("jax", "digit2", None),
     ("jax", "auto", 13), ("numpy", "auto", 13)],
)
def test_jax_archives_load_in_port(backend, layout, bit_len, rng, tmp_path):
    """Each archive kind the JAX package writes: packed planes, numpy (D
    itself) and digit2 (D's two digit planes) load as the backend and the
    layout the archive names; responses are the JAX server's."""
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    jax_server, _, _ = chalametpir_tpu.Server.setup(
        seed, db, backend=backend, layout=layout, rng=rng, mat_elem_bit_len=bit_len
    )
    path = str(tmp_path / "jax_server.npz")
    jax_server.save(path)
    q = _queries(jax_server)
    want = jax_server.respond_batch(q)
    assert np.array_equal(Server.load(path, device="cpu").respond_batch(q), want)
    assert np.array_equal(convert.server_from_jax_archive(path, "cpu").respond_batch(q), want)


def test_paths_without_a_suffix(rng, tmp_path):
    """np.savez(str) appends '.npz' to a path without a suffix: save and
    load keep to the literal path, server and client alike."""
    db = generate_random_kv_database(200, rng=rng, value_byte_len=(4, 16))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, rng=rng, device="cpu")
    client = Client.setup(seed, hint, fparams, device="cpu")
    key = next(iter(db))
    q = _query(client, key)
    server.save(str(tmp_path / "serverstate"))
    client.save(str(tmp_path / "clientstate"))
    assert (tmp_path / "serverstate").exists() and (tmp_path / "clientstate").exists()
    loaded = Server.load(str(tmp_path / "serverstate"), device="cpu")
    restored = Client.load(str(tmp_path / "clientstate"), device="cpu")
    assert loaded.respond(q) == server.respond(q)
    assert restored.process_response(key, loaded.respond(q)) == db[key]


@pytest.mark.parametrize("mode", ["stream", "ctr"])
def test_client_save_load_keeps_pending_queries(mode, rng, tmp_path):
    """A restarted client answers the queries pending at save; the
    prepared pool is not persisted, so the next query runs inline; a key
    still pending stays guarded against a second query."""
    db = generate_random_kv_database(300, rng=rng, value_byte_len=(8, 64))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, prg_mode=mode, rng=rng, device="cpu")
    client = Client.setup(seed, hint, fparams, prg_mode=mode, device="cpu", prepared_queries=3)
    keys = list(db)[:4]
    pending = {key: _query(client, key) for key in keys[:2]}
    path = str(tmp_path / "client.npz")
    client.save(path)
    restored = Client.load(path, device="cpu")
    assert isinstance(restored, Client) and restored._prg_mode == mode
    assert restored.uses_device and restored.prepared_query_count == 0
    with pytest.raises(PendingQueryExistsForKey):
        restored.query(keys[0])
    for key, q in pending.items():
        assert restored.process_response(key, server.respond(q)) == db[key]
    q3 = _query(restored, keys[2])
    assert restored.process_response(keys[2], server.respond(q3)) == db[keys[2]]


def test_jax_client_archive_loads_in_port(rng, tmp_path):
    import chalametpir_tpu
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator as JaxOverflow

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(8, 64))
    seed = rng.bytes(32)
    server, hint, fparams = chalametpir_tpu.Server.setup(seed, db, backend="numpy", rng=rng)
    jax_client = chalametpir_tpu.Client.setup(seed, hint, fparams, device=False)
    key = next(iter(db))
    q = _query(jax_client, key, JaxOverflow)
    path = str(tmp_path / "client.npz")
    jax_client.save(path)
    restored = Client.load(path, device="cpu")
    assert restored.process_response(key, server.respond(q)) == db[key]


@pytest.mark.cuda
def test_cuda_server_load_onto_the_card(cuda, tmp_path):
    g = np.random.default_rng(41)
    db = generate_random_kv_database(2000, rng=g, value_byte_len=(1, 120))
    seed = g.bytes(32)
    cpu, hint, fparams = Server.setup(seed, db, rng=np.random.default_rng(2), device="cpu")
    path = str(tmp_path / "server")
    cpu.save(path)
    dev = Server.load(path, device=cuda)
    assert dev.planes.lo.device.type == "cuda"
    q = _queries(cpu, n=5)
    assert np.array_equal(dev.respond_batch(q), cpu.respond_batch(q))
    client = Client.setup(seed, hint, fparams, device=cuda)
    key = next(iter(db))
    q1 = _query(client, key)
    client.save(str(tmp_path / "client"))
    restored = Client.load(str(tmp_path / "client"), device=cuda)
    assert restored._engine.device.type == "cuda"
    assert restored.process_response(key, dev.respond(q1)) == db[key]
