"""Faults of the port against the JAX package, repaired, each driven through
both packages: the `device` values of the JAX client, the order of the
setup argument checks, the dispatcher's `respond_batch_fn` hook and
`pad_batches`, `telemetry.trace_enabled`, and the `backend`, `layout` and
`hint_block_rows` parameters of Server.setup, which the port lacked.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import asyncio
import inspect

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.errors import (
    AcceleratorError,
    ArithmeticOverflowAddingQueryIndicator,
    EmptyKVDatabase,
)
from chalametpir_tpu_torch.models.server import resolve_device
from chalametpir_tpu_torch.net.server import DEMO_DB, BatchDispatcher, PirTcpServer
from chalametpir_tpu_torch.ops.client_device import HostQueryEngine
from chalametpir_tpu_torch.utils import telemetry

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

def _query(client, key):
    """client.query of either package, retried on the protocol's rare
    indicator overflow (each package raises its own class of that name)."""
    while True:
        try:
            return client.query(key)
        except Exception as exc:
            if type(exc).__name__ != ArithmeticOverflowAddingQueryIndicator.__name__:
                raise


@pytest.fixture
def setup(rng):
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, rng=rng, device="cpu")
    return seed, server, hint, fparams


@pytest.mark.parametrize("device", [False, "auto"])
def test_jax_client_device_values_build_an_engine(device, setup, tmp_path):
    """`device=False` and the JAX client's default "auto" (on a machine
    without CUDA) set up the JAX client's host engine in both packages;
    each decodes the same server's responses, also after a save and a load
    with the same value, which gives a host client again."""
    if device == "auto" and torch.cuda.is_available():
        pytest.skip("with CUDA \"auto\" is the card: see the cuda-marked case")
    import chalametpir_tpu

    seed, server, hint, fparams = setup
    for package in (chalametpir_tpu.Client, Client):
        client = package.setup(seed, hint, fparams, device=device)
        assert client.process_response(b"kiwi", server.respond(_query(client, b"kiwi"))) == b"brown"
        pending = _query(client, b"plum")
        path = str(tmp_path / f"{package.__module__}.npz")
        client.save(path)
        loaded = package.load(path, device=device)
        assert loaded.process_response(b"plum", server.respond(pending)) == b"purple"
        for each in (client, loaded):
            # the JAX client holds A itself and no engine; the port's host engine holds it
            host_a = each._engine.pub_mat_a if package is Client else each._pub_mat_a
            assert not each.uses_device and host_a is not None
            assert isinstance(each._engine, HostQueryEngine) if package is Client else each._engine is None
    assert Client.setup(seed, hint, fparams, device=device).setup_stats["engine"] == "host"


@pytest.mark.parametrize("device", [False, "auto"])
def test_server_takes_the_same_device_values(device, setup, tmp_path):
    if device == "auto" and torch.cuda.is_available():
        pytest.skip("with CUDA \"auto\" is the card: see the cuda-marked case")
    seed, server, hint, fparams = setup
    again, hint2, _ = Server.setup(seed, DEMO_DB, rng=np.random.default_rng(0), device=device)
    assert again.device.type == "cpu" and len(hint2) == len(hint)
    path = str(tmp_path / "server.npz")
    server.save(path)
    loaded = Server.load(path, device=device)
    q = np.random.default_rng(1).integers(0, 1 << 32, size=(2, server.num_query_cols), dtype=np.uint32)
    assert loaded.device.type == "cpu" and np.array_equal(loaded.respond_batch(q), server.respond_batch(q))


def test_resolve_device_chooses_once_and_never_falls_back(setup):
    """False is the CPU, True is CUDA, "auto" follows the machine; the
    defaults are still "cuda", and a CUDA request without CUDA raises."""
    import chalametpir_tpu

    seed, _, hint, fparams = setup
    assert resolve_device(False) == resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("auto").type == ("cuda" if torch.cuda.is_available() else "cpu")
    for fn in (Server.setup, Server.load, Client.setup, Client.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(chalametpir_tpu.Client.setup).parameters["device"].default == "auto"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request succeeds")
    for device in (True, "cuda", "cuda:0"):
        with pytest.raises(AcceleratorError):
            resolve_device(device)
        with pytest.raises(AcceleratorError):
            Client.setup(seed, hint, fparams, device=device)
        with pytest.raises(AcceleratorError):
            Server.setup(seed, DEMO_DB, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("device", [True, "auto"])
def test_device_true_and_auto_are_the_card(device):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    g = np.random.default_rng(3)
    seed = g.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, rng=g, device=device)
    client = Client.setup(seed, hint, fparams, device=device)
    assert server.device.type == client._engine.device.type == "cuda"
    assert client.process_response(b"kiwi", server.respond(_query(client, b"kiwi"))) == b"brown"


def _no_work(*a, **k):
    raise AssertionError("setup started work before it had checked its arguments")


def test_argument_checks_come_in_the_jax_order(rng, monkeypatch):
    """The DB and the seed are checked before the PRG mode, in both
    packages; the mode is still checked before any work."""
    import chalametpir_tpu
    from chalametpir_tpu_torch.core import encode_db
    from chalametpir_tpu_torch.core.filter import BinaryFuseFilter

    seed = rng.bytes(32)
    with pytest.raises(chalametpir_tpu.errors.EmptyKVDatabase):
        chalametpir_tpu.Server.setup(seed, {}, prg_mode="bad")
    with pytest.raises(EmptyKVDatabase):
        Server.setup(seed, {}, prg_mode="bad", device="cpu")
    for setup in (chalametpir_tpu.Server.setup, lambda *a, **k: Server.setup(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match="seed must be 32 bytes"):
            setup(b"\x01", DEMO_DB, prg_mode="bad")
    for setup in (chalametpir_tpu.Client.setup, lambda *a, **k: Client.setup(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match="seed must be 32 bytes"):
            setup(b"\x01", b"", b"", prg_mode="bad")
    monkeypatch.setattr(encode_db, "from_kv_database", _no_work)
    monkeypatch.setattr(encode_db, "from_kv_database_streaming", _no_work)
    monkeypatch.setattr(BinaryFuseFilter, "from_bytes", _no_work)
    with pytest.raises(ValueError, match="unknown prg mode 'bad'"):
        Server.setup(seed, DEMO_DB, prg_mode="bad", device="cpu")
    with pytest.raises(ValueError, match="unknown prg mode 'bad'"):
        Client.setup(seed, b"", b"", prg_mode="bad", device="cpu")


def _jax_transport():
    from chalametpir_tpu.net import server as jax_net

    return jax_net.BatchDispatcher, jax_net.PirTcpServer


@pytest.mark.parametrize("package", ["port", "jax"])
def test_respond_batch_fn_hook(package, setup):
    """BatchDispatcher and PirTcpServer call `respond_batch_fn` in place of
    server.respond_batch, as the multi-process leader needs."""
    seed, server, hint, fparams = setup
    dispatcher_cls, tcp_cls = (BatchDispatcher, PirTcpServer) if package == "port" else _jax_transport()
    client = Client.setup(seed, hint, fparams, device="cpu")
    seen = []
    direct = server.respond_batch

    def hook(rows):
        seen.append(rows.shape)
        return direct(rows)

    def no_direct_call(rows):
        raise AssertionError("the dispatcher went around respond_batch_fn")

    for make in (lambda: dispatcher_cls(server, respond_batch_fn=hook),
                 lambda: tcp_cls(server, seed, hint, fparams, respond_batch_fn=hook)._dispatcher):
        q = _query(client, b"banana")
        server.respond_batch = no_direct_call
        try:
            response = asyncio.run(make().submit(q))
        finally:
            del server.respond_batch  # back to the class's method
        assert client.process_response(b"banana", response) == b"yellow"
    assert seen == [(1, server.num_query_cols)] * 2


@pytest.mark.parametrize("package", ["port", "jax"])
def test_pad_batches_is_accepted_and_off_by_default(package, setup):
    seed, server, hint, fparams = setup
    dispatcher_cls = BatchDispatcher if package == "port" else _jax_transport()[0]
    client = Client.setup(seed, hint, fparams, device="cpu")
    rows = []
    real = server.respond_batch

    def spy(batch):
        rows.append(batch.shape[0])
        return real(batch)

    for kw, want in (({}, 1), ({"pad_batches": True}, 8)):
        q = _query(client, b"cherry")
        response = asyncio.run(dispatcher_cls(server, max_batch=8, respond_batch_fn=spy, **kw).submit(q))
        assert client.process_response(b"cherry", response) == b"red"
        assert rows.pop() == want


def test_trace_enabled_follows_set_trace():
    from chalametpir_tpu.utils import telemetry as jax_telemetry

    for mod in (telemetry, jax_telemetry):
        before = mod.trace_enabled()
        try:
            mod.set_trace(True)
            assert mod.trace_enabled() is True
            mod.set_trace(False)
            assert mod.trace_enabled() is False
        finally:
            mod.set_trace(before)


@pytest.mark.parametrize("kw", [{"backend": "numpy"}, {"layout": "packed"}, {"hint_block_rows": 64}])
def test_setup_parameters_the_port_does_not_have(kw, rng):
    """Repaired: the port's Server.setup raised TypeError on `backend`,
    `layout` and `hint_block_rows`. It takes them now, and the same call
    through both packages gives the same hint, filter and response bytes
    (the JAX side under its own name for the device backend)."""
    import chalametpir_tpu

    seed = rng.bytes(32)
    state = rng.bit_generator.state
    want_server, want_hint, want_filter = chalametpir_tpu.Server.setup(
        seed, DEMO_DB, rng=rng, **{"backend": "jax", **kw})
    rng.bit_generator.state = state
    server, hint, fparams = Server.setup(seed, DEMO_DB, rng=rng, device="cpu", **kw)
    assert (hint, fparams) == (want_hint, want_filter)
    q = np.random.default_rng(1).integers(0, 1 << 32, size=(3, server.num_query_cols), dtype=np.uint32)
    assert server.respond_batch(q).tobytes() == want_server.respond_batch(q).tobytes()
    assert server.backend == kw.get("backend", "torch")
    # layout "auto" packs at every width here and takes digit2 from b = 13 there
    assert server.layout == want_server._layout or "layout" not in kw
