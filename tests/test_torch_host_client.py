"""Client.setup(device=False) through both packages on the CPU: the JAX
client's host engine (A expanded on the host, s . A by the native ternary
matvec, no torch tensor), on the same 2^10-entry DB in stream and ctr mode
at arity 3 and 4; the routes of "auto", "cpu" and torch.device("cpu");
Client.load and net.client.fetch with device=False; and, on a card, a host
client that launches no kernel and allocates nothing there. The CPU tests
import the JAX package inside each test, so the `cuda` tier runs on a host
without jax."""

import asyncio

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Client, Server, kernels
from chalametpir_tpu_torch.errors import (
    AcceleratorError,
    ArithmeticOverflowAddingQueryIndicator,
    KVDatabaseSizeTooLarge,
)
from chalametpir_tpu_torch.params import LWE_DIMENSION
from chalametpir_tpu_torch.utils import generate_random_kv_database

ENTRIES = 1 << 10
# setup_stats keys of the JAX host client, in stream and ctr mode
JAX_STATS = {"stream": {"a_expand_s", "alloc_s", "xof_s", "wall_s", "cpu_s", "sys_s", "minflt"},
             "ctr": {"a_expand_s", "wall_s", "cpu_s", "sys_s", "minflt"}}


def _query(client, key):
    """client.query of either package, retried on the protocol's rare
    indicator overflow (each package raises its own class of that name)."""
    while True:
        try:
            return client.query(key)
        except Exception as exc:
            if type(exc).__name__ != ArithmeticOverflowAddingQueryIndicator.__name__:
                raise


_DBS: dict = {}


def _deployment(mode: str, arity: int):
    """(db, seed, port server, JAX server, hint, fparams) of the 2^10-entry
    DB, both servers set up from the same seed and generator, built once
    per mode and arity."""
    import chalametpir_tpu

    if (mode, arity) not in _DBS:
        g = np.random.default_rng([7, arity, mode == "ctr"])
        db = generate_random_kv_database(ENTRIES, rng=g, value_byte_len=(1, 64))
        seed = g.bytes(32)
        port, hint, fparams = Server.setup(seed, db, arity=arity, prg_mode=mode, rng=np.random.default_rng(1),
                                           device="cpu")
        jax_server, jax_hint, jax_fparams = chalametpir_tpu.Server.setup(
            seed, db, arity=arity, backend="numpy", prg_mode=mode, rng=np.random.default_rng(1))
        assert (jax_hint, jax_fparams) == (hint, fparams)
        _DBS[mode, arity] = db, seed, port, jax_server, hint, fparams
    return _DBS[mode, arity]


@pytest.mark.parametrize("arity", [3, 4])
@pytest.mark.parametrize("mode", ["stream", "ctr"])
def test_device_false_is_the_jax_host_engine(mode, arity):
    """The port's Client.setup(device=False) is the JAX client's: A equal
    byte for byte, no engine, the JAX setup_stats keys, host_matvec_s and no
    readback in prepare_stats, the same s . A words for one secret, and
    each package's queries answered by either package's server."""
    import chalametpir_tpu

    db, seed, port_server, jax_server, hint, fparams = _deployment(mode, arity)
    want = chalametpir_tpu.Client.setup(seed, hint, fparams, prg_mode=mode, device=False)
    client = Client.setup(seed, hint, fparams, prg_mode=mode, device=False)
    assert client._pub_mat_a.dtype == want._pub_mat_a.dtype == np.uint32
    assert client._pub_mat_a.shape == (LWE_DIMENSION, port_server.num_query_cols)
    assert client._pub_mat_a.tobytes() == want._pub_mat_a.tobytes()
    assert client._engine is None and not client.uses_device and not want.uses_device
    assert JAX_STATS[mode] == set(want.setup_stats)
    assert JAX_STATS[mode] | {"engine", "plane_bytes"} == set(client.setup_stats)
    assert (client.setup_stats["engine"], client.setup_stats["plane_bytes"]) == ("host", 0)
    for each in (client, want):
        each.prepare_queries(3)
        assert "host_matvec_s" in each.prepare_stats and "readback_s" not in each.prepare_stats
        assert each.prepare_stats["count"] == 3
    secret = np.random.default_rng(arity).integers(0, 3, size=LWE_DIMENSION, dtype=np.uint8)
    assert np.array_equal(client._ternary_matvec(secret, client._pub_mat_a),
                          want._ternary_matvec(secret, want._pub_mat_a))
    keys = list(db)[:4]
    for i, key in enumerate(keys):
        for each in (client, want):
            server = (port_server, jax_server)[i % 2]
            assert each.process_response(key, server.respond(_query(each, key))) == db[key]


def test_load_with_device_false_is_a_host_client(tmp_path):
    """Client.load(path, device=False) sets up a host client again from the
    archive, either package's, and resumes its pending queries."""
    import chalametpir_tpu

    db, seed, server, _, hint, fparams = _deployment("stream", 3)
    keys = list(db)[:2]
    for package in (Client, chalametpir_tpu.Client):
        client = package.setup(seed, hint, fparams, device=False)
        pending = _query(client, keys[0])
        path = str(tmp_path / f"{package.__module__}.npz")
        client.save(path)
        loaded = Client.load(path, device=False)
        assert not loaded.uses_device and loaded.setup_stats["engine"] == "host"
        assert loaded.process_response(keys[0], server.respond(pending)) == db[keys[0]]
        assert loaded.process_response(keys[1], server.respond(_query(loaded, keys[1]))) == db[keys[1]]


def test_fetch_with_device_false_is_a_host_client(monkeypatch):
    """net.client.fetch(..., device=False) reaches Client.setup(device=False)
    and fetches every key through the host client."""
    from chalametpir_tpu_torch.net import client as net_client
    from chalametpir_tpu_torch.net.server import PirTcpServer

    db, seed, server, _, hint, fparams = _deployment("stream", 3)
    built = []
    setup = Client.setup
    monkeypatch.setattr(net_client.Client, "setup", lambda *a, **kw: built.append(setup(*a, **kw)) or built[-1])
    keys = list(db)[:3]

    async def run():
        srv = await asyncio.start_server(PirTcpServer(server, seed, hint, fparams).handle, "127.0.0.1", 0)
        async with srv:
            return await net_client.fetch("127.0.0.1", srv.sockets[0].getsockname()[1], keys, device=False, pool=2)

    assert asyncio.run(run()) == {key: db[key] for key in keys}
    assert len(built) == 1 and not built[0].uses_device and built[0].setup_stats["engine"] == "host"


def test_auto_without_cuda_takes_the_host_route(monkeypatch):
    """"auto" on a machine without CUDA is the host engine, as the JAX
    "auto" is without an accelerator; with CUDA it goes to resolve_device,
    which makes it the card."""
    from chalametpir_tpu_torch.models import client as client_module

    db, seed, server, _, hint, fparams = _deployment("ctr", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device="auto")
    assert not client.uses_device and client.setup_stats["engine"] == "host"
    key = next(iter(db))
    assert client.process_response(key, server.respond(_query(client, key))) == db[key]

    class Chosen(Exception):
        pass

    def resolve(device):
        raise Chosen(device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(client_module, "resolve_device", resolve)
    with pytest.raises(Chosen, match="auto"):
        Client.setup(seed, hint, fparams, prg_mode="ctr", device="auto")


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "torch.device"])
def test_cpu_still_builds_the_torch_engine(device):
    """"cpu" and torch.device("cpu") are the device engine on the plain
    versions (the tests' path), not the host engine."""
    db, seed, server, _, hint, fparams = _deployment("stream", 4)
    client = Client.setup(seed, hint, fparams, device=device)
    assert client.uses_device and client._pub_mat_a is None
    assert client._engine.device.type == "cpu" and client.setup_stats["engine"] == "resident"
    key = next(iter(db))
    assert client.process_response(key, server.respond(_query(client, key))) == db[key]


def test_only_false_itself_is_the_host(monkeypatch):
    """device is compared with False by identity: 0 is a device index
    (torch refuses it without a card), and a "cuda" request without CUDA
    raises AcceleratorError; nothing falls back to the host."""
    _, seed, _, _, hint, fparams = _deployment("stream", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((AcceleratorError, RuntimeError)):
        Client.setup(seed, hint, fparams, device=0)
    for device in ("cuda", True):
        with pytest.raises(AcceleratorError):
            Client.setup(seed, hint, fparams, device=device)


def test_host_route_checks_the_a_cap_before_the_expansion(monkeypatch):
    """PIR_CLIENT_MAX_A_BYTES bounds the host expansion in stream mode, as
    in the JAX client: KVDatabaseSizeTooLarge before A is made."""
    from chalametpir_tpu_torch.core import prg

    _, seed, server, _, hint, fparams = _deployment("stream", 3)
    monkeypatch.setenv("PIR_CLIENT_MAX_A_BYTES", str(4 * LWE_DIMENSION * server.num_query_cols - 1))
    monkeypatch.setattr(prg, "expand_seed", lambda *a, **kw: pytest.fail("A expanded past the cap"))
    with pytest.raises(KVDatabaseSizeTooLarge):
        Client.setup(seed, hint, fparams, device=False)


@pytest.mark.cuda
def test_host_client_leaves_the_card_alone():
    """Against a server on the card, Client.setup(device=False), its
    prepared and inline queries and process_response launch no kernel and
    make no allocation on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    g = np.random.default_rng(31)
    db = generate_random_kv_database(ENTRIES, rng=g, value_byte_len=(1, 64))
    seed = g.bytes(32)
    server, hint, fparams = Server.setup(seed, db, rng=g, device="cuda")
    keys = list(db)[:4]
    torch.cuda.synchronize()

    def card():
        return dict(kernels.LAUNCHES), torch.cuda.memory_stats().get("allocation.all.allocated", 0)

    before = card()
    client = Client.setup(seed, hint, fparams, device=False)
    client.prepare_queries(2)
    queries = [_query(client, key) for key in keys[:2]] + [client.query_inline(key) for key in keys[2:]]
    assert card() == before and not client.uses_device
    responses = [server.respond(q) for q in queries]
    torch.cuda.synchronize()
    before = card()
    assert [client.process_response(k, r) for k, r in zip(keys, responses)] == [db[k] for k in keys]
    assert card() == before
