"""Every kind of serving state the port's Server holds (ops/serving.py):
packed planes, digit planes, packed planes sharded over a two-CPU mesh and
the numpy oracle's D, each through its own surface (`upload`, `respond`,
`readback`, `fold_rows`) and through a `Server.save` / `Server.load`
round trip, against the JAX package's server on the same DB: the same
answer bytes, and a fold that adds exactly A_block . D mod 2^32 into the
rows it is given.

The JAX reference is imported inside the test, so the `cuda` tier (`make
check-cuda`) also collects this file on a GPU host without jax."""

import functools

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Server
from chalametpir_tpu_torch.ops.respond import DigitPlanes, HostPlanes
from chalametpir_tpu_torch.ops.respond_packed import PackedPlanes
from chalametpir_tpu_torch.parallel import ShardedPlanes, make_mesh
from chalametpir_tpu_torch.utils import generate_random_kv_database

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

# kind -> (the port's setup keywords, the state class it serves from)
KINDS = {
    "packed": (lambda: dict(layout="packed", device="cpu"), PackedPlanes),
    "digit2": (lambda: dict(layout="digit2", device="cpu"), DigitPlanes),
    "sharded": (lambda: dict(mesh=make_mesh(["cpu"] * 2, data=1, model=2)), ShardedPlanes),
    "numpy": (lambda: dict(backend="numpy"), HostPlanes),
}


@functools.lru_cache(maxsize=None)
def _db():
    g = np.random.default_rng(0x5E5)
    return generate_random_kv_database(300, rng=g, value_byte_len=(1, 64)), g.bytes(32)


def _u32(g, rows: int, cols: int) -> np.ndarray:
    return g.integers(0, 1 << 32, size=(rows, cols), dtype=np.uint32)


@pytest.mark.parametrize("b", [None, 13])
@pytest.mark.parametrize("kind", list(KINDS))
def test_each_state_answers_folds_and_archives_the_jax_bytes(kind, b, tmp_path):
    import chalametpir_tpu

    db, seed = _db()
    kw, cls = KINDS[kind]
    server, hint, _ = Server.setup(seed, db, rng=np.random.default_rng(5), mat_elem_bit_len=b, **kw())
    jax_server, jax_hint, _ = chalametpir_tpu.Server.setup(seed, db, backend="numpy", rng=np.random.default_rng(5),
                                                            mat_elem_bit_len=b)
    assert hint == jax_hint
    state = HostPlanes(server.planes) if kind == "numpy" else server.planes
    assert type(state) is cls and state.device == server.device == torch.device("cpu")
    m, c = server.num_query_cols, server.num_response_cols
    assert state.num_cols == c <= state.c_pad
    g = np.random.default_rng(7)

    # respond: any batch size, also one that does not divide a data axis
    for nq in (1, 3):
        queries = _u32(g, nq, m)
        got = state.readback(state.respond(state.upload(queries)))
        assert got.shape == (nq, c) and got.tobytes() == jax_server.respond_batch(queries).tobytes()

    # fold_rows adds A_block . D into the rows it is given, and nothing past c
    a_block = _u32(g, 5, m)
    before = _u32(g, 5, state.c_pad)
    out = state.upload(before.copy())
    state.fold_rows(state.upload(a_block), out)
    after = state.readback(out)
    assert after[:, :c].tobytes() == (before[:, :c] + jax_server.respond_batch(a_block)).tobytes()
    assert np.array_equal(after[:, c:], before[:, c:])

    # the archive: rebuilt by either package's load, the same answers
    path = str(tmp_path / f"{kind}.npz")
    server.save(path)
    queries = _u32(g, 4, m)
    want = jax_server.respond_batch(queries).tobytes()
    loaded = Server.load(path, device="cpu")
    assert type(loaded.planes) is (PackedPlanes if kind == "sharded" else type(server.planes))
    assert loaded.respond_batch(queries).tobytes() == want
    assert chalametpir_tpu.Server.load(path).respond_batch(queries).tobytes() == want
