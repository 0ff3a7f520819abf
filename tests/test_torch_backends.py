"""Server.setup(backend=, layout=, hint_block_rows=) of the port against the
JAX package's: the numpy oracle, the digit2 layout and the packed layout,
both PRG modes, arity 3 and 4, element widths derived, 8, 13 and 14. The
same seed, DB and rng go through both packages; hint, filter and response
bytes are compared exactly. Then what the two packages raise for unknown
names, the archives in both directions, a full client round trip against
the port's oracle, and `net.server --backend numpy`.

The JAX reference is imported inside the tests that use it, so the `cuda`
tier (`make check-cuda`) also runs on a GPU host without jax."""

import asyncio
import functools
import inspect

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.errors import (
    ArithmeticOverflowAddingQueryIndicator,
    EmptyKVDatabase,
    IncompatibleDimensionForRowVectorTransposedMatrixMultiplication,
)
from chalametpir_tpu_torch.models import server as server_mod
from chalametpir_tpu_torch.net import server as net_server
from chalametpir_tpu_torch.net.client import fetch
from chalametpir_tpu_torch.net.server import DEMO_DB, PirTcpServer
from chalametpir_tpu_torch.ops.respond import DigitPlanes
from chalametpir_tpu_torch.ops.respond_packed import PackedPlanes
from chalametpir_tpu_torch.utils import generate_random_kv_database

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

ENTRIES = 300
# kind -> (the port's keywords, the JAX package's)
KINDS = {
    "numpy": (dict(backend="numpy"), dict(backend="numpy")),
    "digit2": (dict(layout="digit2"), dict(backend="jax", layout="digit2")),
    "packed": (dict(layout="packed"), dict(backend="jax", layout="packed")),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _db(n: int = ENTRIES):
    g = np.random.default_rng(0xD161)
    return generate_random_kv_database(n, rng=g, value_byte_len=(1, 64)), g.bytes(32)


def _queries(server, n=20, seed=9):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(n, server.num_query_cols), dtype=np.uint32)


def _query(client, key):
    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue


@pytest.mark.parametrize("hint_block_rows", [None, 5])
@pytest.mark.parametrize("b", [None, 8, 13, 14])
@pytest.mark.parametrize("arity", [3, 4])
@pytest.mark.parametrize("mode", ["stream", "ctr"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_setup_gives_the_jax_bytes(kind, mode, arity, b, hint_block_rows):
    import chalametpir_tpu

    db, seed = _db()
    port_kw, jax_kw = KINDS[kind]
    common = dict(arity=arity, prg_mode=mode, mat_elem_bit_len=b, hint_block_rows=hint_block_rows)
    want_server, want_hint, want_filter = chalametpir_tpu.Server.setup(
        seed, db, rng=np.random.default_rng(5), **common, **jax_kw)
    server, hint, fparams = Server.setup(seed, db, rng=np.random.default_rng(5), device="cpu", **common, **port_kw)
    assert hint == want_hint and fparams == want_filter
    q = _queries(server)
    assert server.respond_batch(q).tobytes() == want_server.respond_batch(q).tobytes()
    wire = np.array([1, q.shape[1]], "<u4").tobytes() + q[0].astype("<u4").tobytes()
    assert server.respond(wire) == want_server.respond(wire)
    assert server.mat_elem_bit_len == want_server.mat_elem_bit_len
    assert (server.num_query_cols, server.num_response_cols) == (want_server.num_query_cols, want_server.num_response_cols)
    assert server.device.type == "cpu"
    if kind == "numpy":
        assert (server.backend, server.layout) == ("numpy", want_server._layout)
        assert isinstance(server.planes, np.ndarray) and server.planes.dtype == np.uint16
        assert server.planes.tobytes() == np.asarray(want_server._planes).tobytes()
    else:
        assert (server.backend, server.layout) == ("torch", kind) and want_server._layout == kind
        assert isinstance(server.planes, DigitPlanes if kind == "digit2" else PackedPlanes)
        assert server.planes.mat_elem_bit_len == server.mat_elem_bit_len


@pytest.mark.parametrize("b", [None, 13])
def test_auto_layout_stays_packed_and_serves_the_jax_bytes(b):
    """layout="auto": packed at every width in the port; the JAX package
    takes digit2 from b = 13. Same hint and responses."""
    import chalametpir_tpu

    db, seed = _db()
    want_server, want_hint, _ = chalametpir_tpu.Server.setup(
        seed, db, backend="jax", rng=np.random.default_rng(5), mat_elem_bit_len=b)
    server, hint, _ = Server.setup(seed, db, rng=np.random.default_rng(5), mat_elem_bit_len=b, device="cpu")
    assert want_server._layout == ("digit2" if b else "packed") and server.layout == "packed"
    assert hint == want_hint
    q = _queries(server)
    assert np.array_equal(server.respond_batch(q), want_server.respond_batch(q))
    assert Server.setup(seed, db, backend="auto", device="cpu")[0].backend == "torch"


def test_numpy_backend_makes_no_torch_tensor(monkeypatch):
    """The oracle is numpy alone: setup, respond and a save/load round trip
    with every torch tensor factory the server module reaches disabled, and
    no device asked for (the default device is "cuda", which this machine
    may not have)."""
    def no_torch(*a, **k):
        raise AssertionError("the numpy backend touched torch")

    for name in ("zeros", "from_numpy", "full", "empty", "tensor"):
        monkeypatch.setattr(torch, name, no_torch)
    monkeypatch.setattr(server_mod, "resolve_device", no_torch)
    db, seed = _db()
    server, hint, fparams = Server.setup(seed, db, backend="numpy", rng=np.random.default_rng(5))
    q = _queries(server)
    want = (q.astype(np.uint64) @ server.planes.astype(np.uint64)).astype(np.uint32)
    assert np.array_equal(server.respond_batch(q), want) and server.setup_stats == {}
    assert server.device == torch.device("cpu")


@pytest.mark.parametrize("case", ["layout", "backend", "jax_backend", "order", "hint_block_rows", "mesh_first"])
def test_unknown_names_raise_what_and_when_the_jax_server_raises(case, monkeypatch):
    import chalametpir_tpu
    from chalametpir_tpu_torch.core import encode_db

    db, seed = _db()

    def port(*a, **k):
        return Server.setup(*a, device="cpu", **k)

    if case == "layout":
        for setup in (chalametpir_tpu.Server.setup, port):
            with pytest.raises(ValueError, match=r"unknown layout 'rows' \(auto/packed/digit2\)"):
                setup(seed, db, layout="rows")
    elif case == "backend":
        for setup in (chalametpir_tpu.Server.setup, port):
            with pytest.raises(ValueError, match="unknown backend 'cupy'"):
                setup(seed, db, backend="cupy")
    elif case == "jax_backend":
        # decided difference: the port's device backend is "torch"
        with pytest.raises(ValueError, match="torch"):
            port(seed, db, backend="jax")
        chalametpir_tpu.Server.setup(seed, db, backend="jax")
        with pytest.raises(ValueError, match="unknown backend 'torch'"):
            chalametpir_tpu.Server.setup(seed, db, backend="torch")
    elif case == "order":
        # DB, seed, layout, 0-byte values, backend, element width, then (the
        # port alone, before any work) the PRG mode: the JAX order
        bad = dict(layout="rows", backend="cupy", mat_elem_bit_len=99, prg_mode="bad")
        empty_value = {**db, b"k": b""}
        for setup, errors in ((chalametpir_tpu.Server.setup, chalametpir_tpu.errors), (port, server_mod)):
            with pytest.raises(errors.EmptyKVDatabase):
                setup(seed, {}, **bad)
            with pytest.raises(ValueError, match="seed must be 32 bytes"):
                setup(b"\x01", db, **bad)
            with pytest.raises(ValueError, match="unknown layout"):
                setup(seed, empty_value, **bad)
            with pytest.raises(ValueError, match="0-byte values"):
                setup(seed, empty_value, **{**bad, "layout": "digit2"})
            with pytest.raises(ValueError, match="unknown backend"):
                setup(seed, db, **{**bad, "layout": "digit2"})
            with pytest.raises(errors.ImpossibleEncodedDBMatrixElementBitLength):
                setup(seed, db, **{**bad, "layout": "digit2", "backend": "numpy"})
        monkeypatch.setattr(encode_db, "from_kv_database", lambda *a, **k: pytest.fail("work before the checks"))
        with pytest.raises(ValueError, match="unknown prg mode 'bad'"):
            port(seed, db, prg_mode="bad", backend="numpy")
        assert EmptyKVDatabase is server_mod.EmptyKVDatabase
    elif case == "hint_block_rows":
        with pytest.raises(ValueError, match="hint_block_rows"):
            port(seed, db, hint_block_rows=0)
        # past the LWE dimension it is one block, as in the JAX package
        want = chalametpir_tpu.Server.setup(seed, db, backend="jax", layout="digit2", hint_block_rows=5000,
                                            rng=np.random.default_rng(5))[1]
        for layout in ("digit2", "packed"):
            assert port(seed, db, layout=layout, hint_block_rows=5000, rng=np.random.default_rng(5))[1] == want
    else:
        # a mesh decides before the backend does, in both packages: with a
        # mesh, backend="numpy" still builds the sharded packed server
        from chalametpir_tpu_torch.parallel import ShardedPlanes, make_mesh

        server, hint, _ = Server.setup(seed, db, backend="numpy", layout="digit2", rng=np.random.default_rng(5),
                                       mesh=make_mesh(["cpu"] * 2, data=1, model=2))
        assert isinstance(server.planes, ShardedPlanes) and (server.backend, server.layout) == ("torch", "packed")
        assert hint == port(seed, db, rng=np.random.default_rng(5))[1]
        params = inspect.signature(chalametpir_tpu.Server.setup).parameters
        assert set(params) - {"cls"} <= set(inspect.signature(Server.setup).parameters)


@pytest.mark.parametrize("b", [None, 13])
@pytest.mark.parametrize("kind", list(KINDS))
def test_port_archives_load_in_jax_and_back(kind, b, tmp_path):
    """save of each kind -> chalametpir_tpu.Server.load answers the same,
    under the backend and layout the JAX package would have written; the
    JAX package's archive of the same kind -> the port's load rebuilds that
    kind (decided: `load` keeps the layout the archive names, as the JAX
    `load` does) and answers the same."""
    import ast

    import chalametpir_tpu

    db, seed = _db()
    port_kw, jax_kw = KINDS[kind]
    server, _, _ = Server.setup(seed, db, rng=np.random.default_rng(5), mat_elem_bit_len=b, device="cpu", **port_kw)
    jax_server, _, _ = chalametpir_tpu.Server.setup(seed, db, rng=np.random.default_rng(5), mat_elem_bit_len=b, **jax_kw)
    q = _queries(server)
    want = server.respond_batch(q)
    paths = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    server.save(paths[0])
    jax_server.save(paths[1])
    metas, names = [], []
    for path in paths:
        with np.load(path) as archive:
            metas.append(ast.literal_eval(str(archive["meta"][0])))
            names.append(sorted(archive.files))
            if kind != "packed":  # the same bytes in both archives
                for name in archive.files:
                    if name != "meta":
                        with np.load(paths[1]) as ref:
                            assert archive[name].tobytes() == ref[name].tobytes()
    assert metas[0] == metas[1] and names[0] == names[1]
    loaded_by_jax = chalametpir_tpu.Server.load(paths[0])
    assert (loaded_by_jax._backend, loaded_by_jax._layout) == (jax_server._backend, jax_server._layout)
    assert np.array_equal(loaded_by_jax.respond_batch(q), want)
    for path in paths:
        loaded = Server.load(path, device="cpu")
        assert (loaded.backend, loaded.layout) == (server.backend, server.layout)
        assert type(loaded.planes) is type(server.planes) and loaded.mat_elem_bit_len == server.mat_elem_bit_len
        assert np.array_equal(loaded.respond_batch(q), want)
    with pytest.raises(IncompatibleDimensionForRowVectorTransposedMatrixMultiplication):
        loaded.respond_batch(q[:, :-1])


@pytest.mark.parametrize("mode", ["stream", "ctr"])
@pytest.mark.parametrize("kind", ["numpy", "digit2"])
def test_client_round_trip_against_the_port_server(kind, mode):
    db, seed = _db()
    server, hint, fparams = Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(5), device="cpu",
                                         **KINDS[kind][0])
    client = Client.setup(seed, hint, fparams, prg_mode=mode, device="cpu")
    for key in list(db)[:4]:
        assert client.process_response(key, server.respond(_query(client, key))) == db[key]


def test_net_server_backend_numpy_serves_a_key(monkeypatch):
    served = []

    async def no_serve(self, host, port):  # record the server instead of serving forever
        served.append(self)

    monkeypatch.setattr(PirTcpServer, "serve", no_serve)
    net_server.main(["--backend", "numpy", "--device", "cpu"])
    (tcp,) = served
    assert tcp._server.backend == "numpy" and isinstance(tcp._server.planes, np.ndarray)
    monkeypatch.undo()

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        async with srv:
            return await fetch("127.0.0.1", srv.sockets[0].getsockname()[1], [b"kiwi", b"plum"], device="cpu")

    assert asyncio.run(run()) == {b"kiwi": DEMO_DB[b"kiwi"], b"plum": DEMO_DB[b"plum"]}
    with pytest.raises(SystemExit):
        net_server.main(["--backend", "numpy", "--device", "cpu", "--mesh", "1x2"])
    with pytest.raises(SystemExit):
        net_server.main(["--backend", "jax", "--device", "cpu"])


# -- the card against the CPU plain run ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b", [None, 13])
@pytest.mark.parametrize("mode", ["stream", "ctr"])
def test_cuda_three_layouts_equal_the_cpu_run(mode, b, cuda, tmp_path):
    g = np.random.default_rng(17)
    db = generate_random_kv_database(3000, rng=g, value_byte_len=(1, 120))
    seed = g.bytes(32)
    kw = dict(prg_mode=mode, mat_elem_bit_len=b)
    cpu, hint, fparams = Server.setup(seed, db, rng=np.random.default_rng(5), device="cpu", **kw)
    q = _queries(cpu, n=40)
    want = cpu.respond_batch(q)
    for more in (dict(layout="packed"), dict(layout="digit2"), dict(layout="digit2", hint_block_rows=7),
                 dict(layout="packed", hint_block_rows=7), dict(backend="numpy")):
        server, h, f = Server.setup(seed, db, rng=np.random.default_rng(5), device=cuda, **kw, **more)
        assert (h, f) == (hint, fparams), more
        assert server.device.type == ("cpu" if "backend" in more else "cuda")
        assert np.array_equal(server.respond_batch(q), want), more
        if more == dict(layout="digit2"):
            assert server.planes.d0.device.type == "cuda" and not server.planes.d0.shape[1] % 8
            path = str(tmp_path / "digit2")
            server.save(path)
            loaded = Server.load(path, device=cuda)
            assert loaded.layout == "digit2" and loaded.planes.d0.device.type == "cuda"
            assert np.array_equal(loaded.respond_batch(q), want)
