"""The port's TCP entry points (chalametpir_tpu_torch.net) on the CPU:
round trips with the port's server and client in both PRG modes and
across the two packages, micro-batching without padding, and the
--save-state / --load-state path of the server's main."""

import asyncio

import numpy as np
import pytest
import torch

from chalametpir_tpu.core import matrix_io
from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.net import server as net_server
from chalametpir_tpu_torch.net.client import fetch
from chalametpir_tpu_torch.net.server import DEMO_DB, BatchDispatcher, PirTcpServer

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

KEYS = [b"banana", b"cherry", b"kiwi"]


def _serve_and_fetch(tcp, keys, fetch_fn=fetch, **kw):
    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            return await fetch_fn("127.0.0.1", port, keys, **kw)

    return asyncio.run(run())


@pytest.mark.parametrize("mode,pool", [("stream", 0), ("ctr", 0), ("stream", 2)])
def test_tcp_round_trip(mode, pool, rng):
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, prg_mode=mode, rng=rng, device="cpu")
    tcp = PirTcpServer(server, seed, hint, fparams)
    got = _serve_and_fetch(tcp, KEYS, prg_mode=mode, device="cpu", pool=pool)
    assert got == {key: DEMO_DB[key] for key in KEYS}
    assert tcp._dispatcher.served == len(KEYS)


def test_port_server_with_jax_fetch(rng):
    from chalametpir_tpu.net.client import fetch as jax_fetch

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, rng=rng, device="cpu")
    got = _serve_and_fetch(PirTcpServer(server, seed, hint, fparams), KEYS, jax_fetch, device=False)
    assert got == {key: DEMO_DB[key] for key in KEYS}


def test_jax_server_with_port_fetch(rng):
    import chalametpir_tpu

    seed = rng.bytes(32)
    server, hint, fparams = chalametpir_tpu.Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    got = _serve_and_fetch(PirTcpServer(server, seed, hint, fparams), KEYS, device="cpu")
    assert got == {key: DEMO_DB[key] for key in KEYS}


def _queries_for(client, keys):
    out = []
    for key in keys:
        while True:
            try:
                out.append(client.query(key))
                break
            except ArithmeticOverflowAddingQueryIndicator:
                continue
    return out


def test_concurrent_queries_coalesce_without_padding(rng):
    """Queued queries ride fewer respond_batch calls than there are
    queries, and no batch is padded: the port's server has no `_backend`
    for the dispatcher to pad for (its kernel compiles no batch shape)."""
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, rng=rng, device="cpu")
    client = Client.setup(seed, hint, fparams, device="cpu")
    keys = [b"apple", b"banana", b"grape", b"kiwi", b"plum", b"peach"]
    queries = _queries_for(client, keys)
    rows = []
    real = server.respond_batch

    def spying_respond(batch):
        rows.append(batch.shape[0])
        return real(batch)

    server.respond_batch = spying_respond  # the dispatcher binds it at construction
    tcp = PirTcpServer(server, seed, hint, fparams, max_batch=8)
    assert tcp._dispatcher._pad_batches is False
    assert BatchDispatcher(server)._pad_batches is False

    async def run():
        return await asyncio.gather(*(tcp._dispatcher.submit(q) for q in queries))

    responses = asyncio.run(run())
    for key, resp in zip(keys, responses):
        assert client.process_response(key, resp) == DEMO_DB[key]
    assert sum(rows) == len(keys)  # no padded rows
    assert tcp._dispatcher.batches == len(rows) < len(keys)
    assert tcp._dispatcher.served == len(keys)


def test_dispatcher_rejects_a_malformed_query(rng):
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, rng=rng, device="cpu")
    bad = matrix_io.matrix_to_bytes(np.zeros((1, 3), np.uint32))
    from chalametpir_tpu.errors import IncompatibleDimensionForRowVectorTransposedMatrixMultiplication

    async def run():
        with pytest.raises(IncompatibleDimensionForRowVectorTransposedMatrixMultiplication):
            await BatchDispatcher(server).submit(bad)

    asyncio.run(run())


def test_main_save_state_then_load_state(tmp_path, monkeypatch):
    """`main --save-state` sets up and archives the server; `main
    --load-state` resumes from the archive without setup; both serve."""
    served = []

    async def no_serve(self, host, port):  # record the server instead of serving forever
        served.append(self)

    monkeypatch.setattr(PirTcpServer, "serve", no_serve)
    prefix = str(tmp_path / "serving")
    net_server.main(["--device", "cpu", "--save-state", prefix])
    net_server.main(["--device", "cpu", "--load-state", prefix])
    first, resumed = served
    assert (resumed._seed, resumed._hint, resumed._filter_params) == (
        first._seed, first._hint, first._filter_params
    )
    q = np.random.default_rng(1).integers(0, 1 << 32, size=(2, first._server.num_query_cols),
                                          dtype=np.uint32)
    assert np.array_equal(resumed._server.respond_batch(q), first._server.respond_batch(q))
    monkeypatch.undo()
    assert _serve_and_fetch(resumed, [b"kiwi"], device="cpu") == {b"kiwi": b"brown"}
    with pytest.raises(SystemExit):
        net_server.main(["--device", "cpu", "--load-state", prefix, "--random-db", "5"])


def test_load_serving_state_reads_a_jax_state(rng, tmp_path):
    import chalametpir_tpu
    from chalametpir_tpu.net.server import save_serving_state

    seed = rng.bytes(32)
    server, hint, fparams = chalametpir_tpu.Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    prefix = str(tmp_path / "jax_serving")
    save_serving_state(prefix, server, seed, hint, fparams)
    loaded, seed2, hint2, fparams2 = net_server.load_serving_state(prefix, device="cpu")
    assert (seed2, hint2, fparams2) == (seed, hint, fparams)
    got = _serve_and_fetch(PirTcpServer(loaded, seed2, hint2, fparams2), KEYS, device="cpu")
    assert got == {key: DEMO_DB[key] for key in KEYS}
