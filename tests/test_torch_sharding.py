"""The port's sharded serving path (chalametpir_tpu_torch/parallel/
sharding.py, Server.setup(mesh=...), `net.server --mesh`) on in-process
meshes of CPU shards, after tests/test_sharding.py's packed cases, and at
the end the digit2 shard functions after its digit2 cases. Each
case holds the port against the JAX package's sharded path on its
8-device virtual CPU mesh (Pallas interpreted) and against the port's own
unsharded server. Every value is a u32 mod 2^32: exact equality,
tolerance 0.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.core import matrix_io
from chalametpir_tpu_torch.errors import AcceleratorError, ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu_torch.net import server as net_server
from chalametpir_tpu_torch.ops import respond_packed as rp
from chalametpir_tpu_torch.parallel import (
    build_sharded_pallas_db,
    make_mesh,
    pad_db_planes,
    shard_db_planes,
    sharded_hint_accumulate_fn,
    sharded_hint_ctr_packed,
    sharded_hint_packed_fn,
    sharded_respond_fn,
    sharded_respond_packed_fn,
)
from chalametpir_tpu_torch.parallel import sharding as sh
from chalametpir_tpu_torch.utils import generate_random_kv_database

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

# (data, model): the 2x4 mesh of tests/test_sharding.py, and a model axis
# that does not divide m / 2048 (m_pad grows past the unsharded padding)
SHAPES = [(2, 4), (1, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _mesh(shape, device="cpu"):
    data, model = shape
    return make_mesh([device] * (data * model), data=data, model=model)


def _jax_mesh(shape):
    import jax

    from chalametpir_tpu.parallel import make_mesh as jax_make_mesh

    data, model = shape
    if len(jax.devices()) < data * model:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return jax_make_mesh(jax.devices()[: data * model], data=data, model=model)


def _i32(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().numpy().view(np.uint32)


def _oracle(queries: np.ndarray, mat: np.ndarray) -> np.ndarray:
    return (queries.astype(np.uint64) @ mat.astype(np.uint64)).astype(np.uint32)


def _query(client, key):
    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue


def _random_queries(server, rng, n=4):
    return rng.integers(0, 1 << 32, size=(n, server.num_query_cols), dtype=np.uint32)


def test_make_mesh_defaults_and_errors():
    """The JAX function's defaulting (all on `model`; one axis given, the
    other by division) and its ValueError, word for word."""
    import jax

    from chalametpir_tpu.parallel import make_mesh as jax_make_mesh

    for kw in ({}, {"data": 2}, {"model": 2}, {"data": 2, "model": 4}):
        port, ref = make_mesh(["cpu"] * 8, **kw), jax_make_mesh(jax.devices()[:8], **kw)
        assert dict(port.shape) == dict(ref.shape)
        assert [len(row) for row in port.devices] == [port.shape["model"]] * port.shape["data"]
    for kw in ({"data": 3, "model": 2}, {"data": 3}, {"model": 5}):
        with pytest.raises(ValueError) as ref_err:
            jax_make_mesh(jax.devices()[:8], **kw)
        with pytest.raises(ValueError) as port_err:
            make_mesh(["cpu"] * 8, **kw)
        assert str(port_err.value) == str(ref_err.value)
    if not torch.cuda.is_available():
        for devices in (None, ["cuda:0"] * 2):
            with pytest.raises(AcceleratorError):
                make_mesh(devices)
    with pytest.raises(ValueError):
        sh.Mesh(1, 2)  # neither devices nor a process group


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [8, 10, 13])
def test_sharded_plane_bytes_match_jax(b, shape, rng):
    from chalametpir_tpu.parallel import build_sharded_pallas_db as jax_build

    mat = rng.integers(0, 1 << b, size=(700, 40), dtype=np.uint16)
    mesh = _mesh(shape)
    db = build_sharded_pallas_db(mesh, mat, b)
    ref = jax_build(_jax_mesh(shape), mat, b)
    assert db.m_pad == ref.lo.shape[0] == shape[1] * 2048  # whole tiles per model shard
    lo, hi = db.gather()
    assert np.array_equal(lo.numpy(), np.asarray(ref.lo))
    assert (hi is None) == (ref.hi is None) == (b <= 8)
    if hi is not None:
        assert np.array_equal(hi.numpy(), np.asarray(ref.hi))
    # one device under every cell: its planes are placed once, shards are views
    assert len(db.runs) == 1 and db.device_bytes == lo.numel() + (hi.numel() if hi is not None else 0)
    lo1, _ = db.shard(1, torch.device("cpu"))
    assert lo1.data_ptr() == db.runs[torch.device("cpu")][1].data_ptr() + db.m_local * lo.shape[1]
    assert (lo[700:] == -128).all()  # padded rows hold value zero


@pytest.mark.parametrize("b", [8, 10])
def test_build_packed_db_m_align_matches_jax(b, rng):
    """`m_align` pads the rows of one device's planes as the JAX builder's."""
    from chalametpir_tpu.ops.respond_pallas import build_pallas_db

    mat = rng.integers(0, 1 << b, size=(700, 40), dtype=np.uint16)
    port, ref = rp.build_packed_db(mat, b, "cpu", m_align=3 * 2048), build_pallas_db(mat, b, m_align=3 * 2048)
    assert port.lo.shape[0] == 3 * 2048 and np.array_equal(port.lo.numpy(), np.asarray(ref.lo))
    assert (port.hi is None) == (ref.hi is None)
    if port.hi is not None:
        assert np.array_equal(port.hi.numpy(), np.asarray(ref.hi))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", [8, 10])  # 8 = lo-only plane (the 2^23-scale geometry)
def test_sharded_packed_respond_exact(b, shape, rng):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from chalametpir_tpu.parallel import build_sharded_pallas_db as jax_build
    from chalametpir_tpu.parallel import sharded_respond_packed_fn as jax_respond_fn

    q, m, c = 4, 700, 40
    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    mesh = _mesh(shape)
    db = build_sharded_pallas_db(mesh, mat, b)
    q_pad = np.pad(queries, ((0, 0), (0, db.m_pad - m)))
    got = _u32(sharded_respond_packed_fn(mesh, db)(_i32(q_pad)))

    jmesh = _jax_mesh(shape)
    jdb = jax_build(jmesh, mat, b)
    want = np.asarray(jax_respond_fn(jmesh, jdb)(
        jax.device_put(q_pad, NamedSharding(jmesh, P("data", "model")))))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _oracle(queries, mat))
    unsharded = rp.respond_batch_packed(_i32(queries), rp.build_packed_db(mat, b, "cpu"))
    assert np.array_equal(got, _u32(unsharded))
    with pytest.raises(ValueError):  # the caller pads to m_pad columns
        sharded_respond_packed_fn(mesh, db)(_i32(queries))


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_hint_step_matches_jax(shape, rng):
    """A block of A's rows as the queries, the same for every data row (5
    rows do not split over 2 data rows: the hint step does not split)."""
    from chalametpir_tpu.parallel import build_sharded_pallas_db as jax_build
    from chalametpir_tpu.parallel import sharded_hint_packed_fn as jax_hint_fn

    r, m, c, b = 5, 700, 40, 10
    a_block = rng.integers(0, 1 << 32, size=(r, m), dtype=np.uint32)
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    mesh = _mesh(shape)
    db = build_sharded_pallas_db(mesh, mat, b)
    a_pad = np.pad(a_block, ((0, 0), (0, db.m_pad - m)))
    got = _u32(sharded_hint_packed_fn(mesh, db)(_i32(a_pad)))
    jmesh = _jax_mesh(shape)
    assert np.array_equal(got, np.asarray(jax_hint_fn(jmesh, jax_build(jmesh, mat, b))(a_pad)))
    assert np.array_equal(got, _oracle(a_block, mat))
    if shape[0] > 1:
        with pytest.raises(ValueError):  # respond splits its rows over `data`
            sharded_respond_packed_fn(mesh, db)(_i32(a_pad))


@pytest.mark.parametrize("shape", SHAPES)
def test_server_api_sharded_round_trip(shape, rng):
    """Full protocol through Server.setup(mesh=...), stream mode: the same
    bytes as the JAX package's mesh setup and as the port without a mesh."""
    import chalametpir_tpu

    db = generate_random_kv_database(500, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    fseed = int(rng.integers(0, 2**63))
    mesh = _mesh(shape)
    server, hint, fparams = Server.setup(seed, db, arity=3, mesh=mesh, rng=np.random.default_rng(fseed))
    assert server.planes.mesh is mesh
    ref, ref_hint, ref_fparams = chalametpir_tpu.Server.setup(
        seed, db, arity=3, mesh=_jax_mesh(shape), rng=np.random.default_rng(fseed))
    one, one_hint, one_fparams = Server.setup(seed, db, arity=3, rng=np.random.default_rng(fseed), device="cpu")
    assert fparams == ref_fparams == one_fparams
    assert hint == ref_hint == one_hint
    assert (server.num_query_cols, server.num_response_cols, server.mat_elem_bit_len) == (
        ref.num_query_cols, ref.num_response_cols, ref.mat_elem_bit_len)
    for n in (1, 3, 4):  # 1 and 3 rows are padded to a multiple of `data`
        queries = _random_queries(server, rng, n)
        got = server.respond_batch(queries)
        assert got.shape == (n, server.num_response_cols)
        assert np.array_equal(got, ref.respond_batch(queries))
        assert np.array_equal(got, one.respond_batch(queries))

    client = Client.setup(seed, hint, fparams, device=False)
    for key in list(db)[:3]:
        q = _query(client, key)
        assert server.respond(q) == one.respond(q)
        assert client.process_response(key, server.respond(q)) == db[key]


def test_server_api_sharded_scaled_2pow23_geometry(rng):
    """The 2^23 x 1 kB target, scaled down: b = 8 (what the derivation gives
    at 2^23 entries) and 1 kB values over a lo plane alone."""
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1024, 1024))
    seed = rng.bytes(32)
    fseed = int(rng.integers(0, 2**63))
    kw = dict(arity=3, mat_elem_bit_len=8)
    server, hint, fparams = Server.setup(seed, db, mesh=_mesh((2, 4)), rng=np.random.default_rng(fseed), **kw)
    assert server.mat_elem_bit_len == 8
    assert all(hi is None for _, _, hi in server.planes.runs.values())  # b = 8 stores one byte plane
    ref, ref_hint, ref_fparams = chalametpir_tpu.Server.setup(
        seed, db, mesh=_jax_mesh((2, 4)), rng=np.random.default_rng(fseed), **kw)
    one, one_hint, _ = Server.setup(seed, db, rng=np.random.default_rng(fseed), device="cpu", **kw)
    assert (hint, fparams) == (ref_hint, ref_fparams) and hint == one_hint
    queries = _random_queries(server, rng, 3)
    got = server.respond_batch(queries)
    assert np.array_equal(got, ref.respond_batch(queries))
    assert np.array_equal(got, one.respond_batch(queries))
    # oracle on this server's own planes: D back from the shards
    lo, _ = server.planes.gather()
    d = (lo.numpy().astype(np.int16) + 128)[: server.num_query_cols, : server.num_response_cols]
    assert np.array_equal(got, _oracle(queries, d))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arity", [3, 4])
def test_server_api_sharded_ctr_round_trip(arity, shape, rng):
    """ctr mode under a mesh: every shard generates its own range of A; the
    hint bytes equal the JAX mesh setup's and the single-device ctr
    setup's."""
    import chalametpir_tpu

    db = generate_random_kv_database(400, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    fseed = int(rng.integers(0, 2**63))
    kw = dict(arity=arity, prg_mode="ctr")
    server, hint, fparams = Server.setup(seed, db, mesh=_mesh(shape), rng=np.random.default_rng(fseed), **kw)
    ref, ref_hint, ref_fparams = chalametpir_tpu.Server.setup(
        seed, db, mesh=_jax_mesh(shape), rng=np.random.default_rng(fseed), **kw)
    one, one_hint, one_fparams = Server.setup(seed, db, rng=np.random.default_rng(fseed), device="cpu", **kw)
    assert fparams == ref_fparams == one_fparams
    assert hint == ref_hint == one_hint
    assert matrix_io.matrix_from_bytes(hint).shape == (1774, server.num_response_cols)
    queries = _random_queries(server, rng)
    assert np.array_equal(server.respond_batch(queries), ref.respond_batch(queries))
    assert np.array_equal(server.respond_batch(queries), one.respond_batch(queries))
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
    for key in list(db)[:3]:
        assert client.process_response(key, server.respond(_query(client, key))) == db[key]


def test_sharded_chunk_rows_equal_the_jax_function():
    """Always a multiple of the tile that divides m_local exactly, equal to
    the JAX function over its test's sweep; misaligned planes raise."""
    from chalametpir_tpu.parallel.sharding import _sharded_chunk_rows as jax_chunk_rows

    tile_k = 2048
    for t in list(range(1, 400)) + [1009, 1024, 130 * 4, 197 * 3]:
        m_local = t * tile_k
        cc = sh._sharded_chunk_rows(m_local, tile_k)
        assert cc == jax_chunk_rows(m_local, tile_k)
        assert cc % tile_k == 0 and m_local % cc == 0 and cc <= max(1 << 17, tile_k)
    # 2^20 entries, arity 3, over 4 shards: 144 tiles a shard in 3 chunks of 48
    assert sh._sharded_chunk_rows(294_912, 2048) == 98_304
    for fn in (sh._sharded_chunk_rows, jax_chunk_rows):
        with pytest.raises(AssertionError):
            fn(2048 * 3 + 1, 2048)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_ctr_hint_multi_chunk_matches_single_device(shape, rng, monkeypatch):
    """Several fold chunks per shard (the chunk picker forced to one tile):
    every chunk but the first of the first shard starts in the middle of
    the ctr stream. The hint equals the single-device ctr derivation of
    both packages byte for byte (a dropped or re-read row changes it)."""
    import chalametpir_tpu

    monkeypatch.setattr(sh, "_sharded_chunk_rows", lambda m_local, tile_k: tile_k)
    db = generate_random_kv_database(7000, rng=rng, value_byte_len=(1, 48))
    seed = rng.bytes(32)
    fseed = int(rng.integers(0, 2**63))
    kw = dict(arity=3, prg_mode="ctr")
    server, hint_mesh, fp_mesh = Server.setup(seed, db, mesh=_mesh(shape), rng=np.random.default_rng(fseed), **kw)
    assert server.planes.m_local > 2048  # more than one chunk a shard
    _, hint_one, fp_one = Server.setup(seed, db, rng=np.random.default_rng(fseed), device="cpu", **kw)
    _, hint_jax, fp_jax = chalametpir_tpu.Server.setup(
        seed, db, backend="jax", rng=np.random.default_rng(fseed), **kw)
    assert fp_mesh == fp_one == fp_jax
    assert hint_mesh == hint_one == hint_jax


def test_sharded_ctr_hint_function_matches_fold_of_whole_a(rng):
    """sharded_hint_ctr_packed on its own planes against A . D with A
    expanded whole by the host engine."""
    from chalametpir_tpu_torch.core import prg

    b, m, c = 9, 3000, 50
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    seed = rng.bytes(32)
    mesh = _mesh((1, 3))
    got = sharded_hint_ctr_packed(mesh, build_sharded_pallas_db(mesh, mat, b), seed)
    a = prg.expand_seed(1774, m, seed, mode="ctr")
    assert got.dtype == np.uint32 and np.array_equal(got, _oracle(a, mat))


@pytest.mark.parametrize("mode", ["stream", "ctr"])
def test_b13_through_a_mesh(mode, rng):
    """b = 13: one hi byte per element (pack 1), the width at which the JAX
    package's unsharded stream path leaves the packed layout; its mesh
    path and the port's stay packed."""
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    fseed = int(rng.integers(0, 2**63))
    kw = dict(arity=3, prg_mode=mode, mat_elem_bit_len=13)
    server, hint, fparams = Server.setup(seed, db, mesh=_mesh((2, 4)), rng=np.random.default_rng(fseed), **kw)
    ref, ref_hint, ref_fparams = chalametpir_tpu.Server.setup(
        seed, db, mesh=_jax_mesh((2, 4)), rng=np.random.default_rng(fseed), **kw)
    one, one_hint, _ = Server.setup(seed, db, rng=np.random.default_rng(fseed), device="cpu", **kw)
    assert (hint, fparams) == (ref_hint, ref_fparams) and hint == one_hint
    queries = _random_queries(server, rng)
    assert np.array_equal(server.respond_batch(queries), ref.respond_batch(queries))
    assert np.array_equal(server.respond_batch(queries), one.respond_batch(queries))


@settings(max_examples=25, deadline=None)
@given(
    m=st.integers(1, 5000), model=st.integers(1, 5), data=st.integers(1, 3),
    rows=st.integers(1, 3), b=st.sampled_from([4, 8, 9, 12, 14]), seed=st.integers(0, 2**32 - 1),
)
def test_sharded_respond_equals_unsharded(m, model, data, rows, b, seed):
    """Any m, mesh and batch on random planes: sharded == unsharded."""
    g = np.random.default_rng(seed)
    c, q = 20, rows * data
    mat = g.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    queries = g.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    mesh = _mesh((data, model))
    db = build_sharded_pallas_db(mesh, mat, b)
    assert db.m_pad == -(-m // (model * 2048)) * model * 2048
    q_pad = np.pad(queries, ((0, 0), (0, db.m_pad - m)))
    got = sharded_respond_packed_fn(mesh, db)(_i32(q_pad))
    want = rp.respond_batch_packed(_i32(queries), rp.build_packed_db(mat, b, "cpu"))
    assert torch.equal(got, want)


def test_sharded_server_save_gathers(rng, tmp_path):
    """Server.save on a sharded server gathers its shards, as the JAX
    package does: either package loads the archive as an unsharded server
    with the same answers."""
    import chalametpir_tpu

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server, _, _ = Server.setup(seed, db, mesh=_mesh((1, 3)), rng=rng)
    path = str(tmp_path / "sharded.npz")
    server.save(path)
    queries = _random_queries(server, rng)
    want = server.respond_batch(queries)
    assert np.array_equal(Server.load(path, device="cpu").respond_batch(queries), want)
    assert np.array_equal(chalametpir_tpu.Server.load(path).respond_batch(queries), want)


def test_main_mesh_flag(monkeypatch, tmp_path, capsys):
    """`--mesh DATAxMODEL` serves a sharded server; it is refused with
    --save-state and --load-state, as the JAX CLI refuses it, and a
    malformed value is an argument error."""
    served = []

    async def no_serve(self, host, port):  # record the server instead of serving forever
        served.append(self)

    monkeypatch.setattr(net_server.PirTcpServer, "serve", no_serve)
    net_server.main(["--device", "cpu", "--mesh", "2x3", "--prg-mode", "ctr"])
    server = served[0]._server
    assert dict(server.planes.mesh.shape) == {"data": 2, "model": 3}
    client = Client.setup(served[0]._seed, served[0]._hint, served[0]._filter_params, prg_mode="ctr", device="cpu")
    assert client.process_response(b"kiwi", server.respond(_query(client, b"kiwi"))) == b"brown"
    prefix = str(tmp_path / "state")
    for argv in (["--mesh", "1x2", "--save-state", prefix], ["--mesh", "1x2", "--load-state", prefix],
                 ["--mesh", "2by2"], ["--mesh", "x"]):
        with pytest.raises(SystemExit):
            net_server.main(["--device", "cpu", *argv])
    assert "--mesh" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(AcceleratorError):  # the default device: the visible cards
            net_server.main(["--mesh", "1x2"])


MESHES_ON_ONE_CARD = [(1, 2), (1, 3), (1, 4), (2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MESHES_ON_ONE_CARD)
@pytest.mark.parametrize("b", [8, 9, 10, 12, 14])  # every pack: 0, 8, 4, 2, 1
def test_sharded_respond_and_hint_step_on_the_card(b, shape, cuda):
    """Every shard on one card: the respond kernel at shard shapes, both
    regimes (one query a data row, and four), against the plain version."""
    from chalametpir_tpu_torch import kernels

    g = np.random.default_rng(100 * b + 10 * shape[0] + shape[1])
    m, c = 9001, 150
    mat = g.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    mesh = _mesh(shape, "cuda:0")
    db = build_sharded_pallas_db(mesh, mat, b)
    assert len(db.runs) == 1 and db.device.type == "cuda"
    plain = rp.build_packed_db(mat, b, cuda)
    for rows in (1, 4):
        queries = g.integers(0, 1 << 32, size=(rows * shape[0], m), dtype=np.uint32)
        q_pad = np.pad(queries, ((0, 0), (0, db.m_pad - m)))
        kernels.reset_launch_counts()
        got = sharded_respond_packed_fn(mesh, db)(_i32(q_pad))
        torch.cuda.synchronize()
        assert sum(kernels.LAUNCHES.values()) == shape[0] * shape[1]  # one launch a cell
        assert got.device.type == "cuda"
        want = rp.respond_packed_ref(_i32(queries, cuda), plain.lo, plain.hi, b, c)
        assert torch.equal(got, want)
        assert np.array_equal(_u32(got), _oracle(queries, mat))
    a_block = g.integers(0, 1 << 32, size=(5, m), dtype=np.uint32)
    kernels.reset_launch_counts()
    got = sharded_hint_packed_fn(mesh, db)(_i32(np.pad(a_block, ((0, 0), (0, db.m_pad - m)))))
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES.values()) == shape[1]  # data row 0 alone
    assert np.array_equal(_u32(got), _oracle(a_block, mat))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MESHES_ON_ONE_CARD)
@pytest.mark.parametrize("b", [8, 9, 10, 12, 14])
def test_sharded_ctr_hint_on_the_card(b, shape, cuda, monkeypatch):
    """The ctr hint with every shard on one card, two chunks a shard: the
    ctr Keccak kernel from the middle of the stream and the fold kernel,
    against A . D with A expanded whole by the host engine."""
    from chalametpir_tpu_torch import kernels
    from chalametpir_tpu_torch.core import prg

    monkeypatch.setattr(sh, "_sharded_chunk_rows", lambda m_local, tile_k: tile_k)
    g = np.random.default_rng(200 * b + 10 * shape[0] + shape[1])
    m, c = 2048 * shape[1] + 77, 150  # two tiles a shard
    mat = g.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    seed = g.bytes(32)
    mesh = _mesh(shape, "cuda:0")
    kernels.reset_launch_counts()
    got = sharded_hint_ctr_packed(mesh, build_sharded_pallas_db(mesh, mat, b), seed)
    assert kernels.LAUNCHES["ctr_keccak"] == kernels.LAUNCHES["respond_packed_mma"] == 2 * shape[1]
    assert np.array_equal(got, _oracle(prg.expand_seed(1774, m, seed, mode="ctr"), mat))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stream", "ctr"])
def test_sharded_server_on_the_card_matches_unsharded(mode, cuda):
    g = np.random.default_rng(31)
    db = generate_random_kv_database(3000, rng=g, value_byte_len=(1, 200))
    seed = g.bytes(32)
    server, hint, fparams = Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(5),
                                         mesh=_mesh((2, 2), "cuda:0"))
    one, one_hint, one_fparams = Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(5), device=cuda)
    assert (hint, fparams) == (one_hint, one_fparams)
    queries = _random_queries(server, g, 5)
    assert np.array_equal(server.respond_batch(queries), one.respond_batch(queries))
    client = Client.setup(seed, hint, fparams, prg_mode=mode, device=cuda)
    for key in list(db)[:3]:
        assert client.process_response(key, server.respond(_query(client, key))) == db[key]


# -- the digit2 shard functions (library functions: the sharded server packs) ----

DIGIT2_SHAPES = [(1, 4), (2, 2), (2, 4)]


def _digit_case(rng, q, m, c, b):
    from chalametpir_tpu_torch.ops import digits

    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    queries[0, :2] = [0x7F7F7F80, 0xFFFFFFFF]
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    return queries, mat, digits.db_digit_planes_np(mat)


@pytest.mark.parametrize("m", [509, 512])
@pytest.mark.parametrize("shape", DIGIT2_SHAPES)
def test_digit2_sharded_respond_matches_jax_and_unsharded(shape, m, rng):
    """pad_db_planes / shard_db_planes / sharded_respond_fn: m = 509 is no
    multiple of any model axis here, so the planes are zero-padded."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from chalametpir_tpu.parallel import pad_db_planes as jax_pad
    from chalametpir_tpu.parallel import shard_db_planes as jax_shard
    from chalametpir_tpu.parallel import sharded_respond_fn as jax_respond_fn
    from chalametpir_tpu_torch.ops import respond

    data, model = shape
    q, c = 2 * data, 27
    queries, mat, (p0, p1) = _digit_case(rng, q, m, c, 14)
    padded, want_padded = pad_db_planes(p0, p1, model), jax_pad(p0, p1, model)
    assert all(a.tobytes() == b.tobytes() and a.shape == b.shape for a, b in zip(padded, want_padded))
    mesh, jmesh = _mesh(shape), _jax_mesh(shape)
    d0, d1 = shard_db_planes(mesh, p0, p1)
    j0, j1 = jax_shard(jmesh, p0, p1)
    assert d0.m_pad == d1.m_pad == j0.shape[0] == -(-m // model) * model and d0.num_cols == c
    assert len(d0.shards) == model and all(t.dtype == torch.int8 for t in d0.shards.values())
    q_pad = np.pad(queries, ((0, 0), (0, d0.m_pad - m)))
    got = _u32(sharded_respond_fn(mesh)(_i32(q_pad), d0, d1))
    want = np.asarray(jax_respond_fn(jmesh)(jax.device_put(q_pad, NamedSharding(jmesh, P("data", "model"))), j0, j1))
    assert got.shape == (q, c) and np.array_equal(got, want) and np.array_equal(got, _oracle(queries, mat))
    unsharded = respond.respond_batch(_i32(queries), torch.from_numpy(p0), torch.from_numpy(p1))
    assert np.array_equal(got, _u32(unsharded))
    assert np.array_equal(_u32(sh._respond_local(_i32(queries), torch.from_numpy(p0), torch.from_numpy(p1))), got)
    with pytest.raises(ValueError):
        sharded_respond_fn(mesh)(_i32(queries[:, :-1]), d0, d1)
    if data > 1:
        with pytest.raises(ValueError):
            sharded_respond_fn(mesh)(_i32(q_pad[:1]), d0, d1)


@pytest.mark.parametrize("shape", DIGIT2_SHAPES)
def test_digit2_sharded_hint_accumulate_matches_jax(shape, rng):
    """sharded_hint_accumulate_fn: two steps over two halves of the DB rows
    add up to A . D; every step equals the JAX step on the same inputs."""
    import jax.numpy as jnp

    from chalametpir_tpu.parallel import shard_db_planes as jax_shard
    from chalametpir_tpu.parallel import sharded_hint_accumulate_fn as jax_accumulate_fn

    r, m, c = 16, 256, 24
    a, mat, (p0, p1) = _digit_case(rng, r, m, c, 12)
    mesh, jmesh = _mesh(shape), _jax_mesh(shape)
    step, jstep = sharded_hint_accumulate_fn(mesh), jax_accumulate_fn(jmesh)
    acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(r, c), dtype=np.int32))
    start = acc.clone()
    jacc = jnp.asarray(acc.numpy())
    half = m // 2
    for rows in (slice(0, half), slice(half, m)):
        d0, d1 = shard_db_planes(mesh, p0[rows], p1[rows])
        j0, j1 = jax_shard(jmesh, p0[rows], p1[rows])
        acc = step(acc, _i32(a[:, rows]), d0, d1)
        jacc = jstep(jacc, a[:, rows], j0, j1)
        assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert np.array_equal(_u32(acc), _oracle(a, mat) + start.numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_cuda_digit2_shard_functions_equal_the_cpu_run(shape, cuda):
    g = np.random.default_rng(23)
    data, model = shape
    queries, mat, (p0, p1) = _digit_case(g, 2 * data, 70001, 27, 14)
    out = {}
    for device in ("cpu", cuda):
        mesh = _mesh(shape, device)
        d0, d1 = shard_db_planes(mesh, p0, p1)
        q_pad = np.pad(queries, ((0, 0), (0, d0.m_pad - queries.shape[1])))
        got = sharded_respond_fn(mesh)(_i32(q_pad), d0, d1)
        acc = sharded_hint_accumulate_fn(mesh)(torch.ones((len(queries), 27), dtype=torch.int32), _i32(q_pad), d0, d1)
        assert got.device.type == acc.device.type == torch.device(device).type
        out[str(device)] = _u32(got), _u32(acc)
    assert np.array_equal(out["cpu"][0], out["cuda"][0]) and np.array_equal(out["cpu"][1], out["cuda"][1])
    assert np.array_equal(out["cuda"][0], _oracle(queries, mat))
