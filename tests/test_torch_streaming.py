"""The port's streaming client engine (chalametpir_tpu_torch/ops/client_device.py
StreamingQueryEngine) against the JAX package's StreamingQueryEngine and
the port's resident engine, and the client's choice between the two
against the JAX client's rule (RESIDENT_PLANES_MAX_BYTES). s . A and the
query bytes are integers: the tolerance is exact equality.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch

import chalametpir_tpu_torch.models.client as port_client_module
from chalametpir_tpu_torch.core import prg
from chalametpir_tpu_torch.errors import (
    AcceleratorError,
    ArithmeticOverflowAddingQueryIndicator,
    InvalidDimensionForVector,
)
from chalametpir_tpu_torch.native import engine as native
from chalametpir_tpu_torch.params import LWE_DIMENSION
from chalametpir_tpu_torch.utils import generate_random_kv_database
from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine, StreamingQueryEngine

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _codes(g: np.random.Generator, q: int) -> np.ndarray:
    return g.integers(0, 3, size=(q, LWE_DIMENSION)).astype(np.int8)


@pytest.mark.parametrize("m,step", [(300, 128), (1000, 64), (96, 512)])
@pytest.mark.parametrize("q", [1, 3])
def test_streaming_matches_jax_streaming_and_resident(m, step, q, rng):
    """Slabs of `step` columns, the last one partial (m is a multiple of
    no step), against the JAX streaming engine and the resident engine."""
    from chalametpir_tpu.ops.client_device import StreamingQueryEngine as JaxStreaming

    seed = rng.bytes(32)
    codes = _codes(rng, q)
    eng = StreamingQueryEngine(seed, m, device="cpu", cols_per_step=step)
    got = eng.matvec_batch(codes)
    assert got.shape == (q, m) and got.dtype == np.uint32
    assert np.array_equal(got, JaxStreaming(seed, m, cols_per_step=step).matvec_batch(codes))
    assert np.array_equal(got, DeviceQueryEngine.from_seed_ctr(seed, m, device="cpu").matvec_batch(codes))
    assert np.array_equal(eng.matvec(codes[0]), got[0])


def test_streaming_async_result_follows_the_engine_contract(rng):
    """The base Client blocks, slices rows and np.asarray's the handle."""
    m = 203
    eng = StreamingQueryEngine(rng.bytes(32), m, device="cpu", cols_per_step=64)
    assert eng.device_bytes == 0
    codes = _codes(rng, 4)
    res = eng.matvec_batch_async(codes).block_until_ready()
    full = np.asarray(res)
    assert full.dtype == np.uint32 and full.shape == (4, 208)
    assert np.array_equal(np.asarray(res[2:3])[0, :m], eng.matvec_batch(codes)[2])


def test_streaming_rejects_bad_shapes(rng):
    eng = StreamingQueryEngine(rng.bytes(32), 50, device="cpu", cols_per_step=64)
    with pytest.raises(InvalidDimensionForVector):
        eng.matvec_batch(np.zeros((2, LWE_DIMENSION - 1), np.int8))
    with pytest.raises(InvalidDimensionForVector):
        eng.matvec(np.zeros(LWE_DIMENSION + 1, np.int8))
    for step in (0, 100):
        with pytest.raises(ValueError):
            StreamingQueryEngine(rng.bytes(32), 50, device="cpu", cols_per_step=step)


def _deterministic_sampler(monkeypatch, seed: int) -> None:
    """Replace both clients' CSPRNG secret/error sampler with one numpy
    stream, so two clients fed the same stream build the same queries."""
    import chalametpir_tpu.models.client as jax_client

    g = np.random.default_rng(seed)
    sampler = staticmethod(lambda n: g.integers(0, 3, size=n).astype(np.int8))
    monkeypatch.setattr(jax_client.Client, "_sample_ternary", sampler)
    monkeypatch.setattr(port_client_module.Client, "_sample_ternary", sampler)


def _query(client, key, overflow=ArithmeticOverflowAddingQueryIndicator):
    """client.query, retried on the indicator overflow (`overflow`: the
    exception class of the client's package)."""
    while True:
        try:
            return client.query(key)
        except overflow:
            continue


@pytest.mark.parametrize("over_budget", [True, False])
def test_engine_choice_matches_jax_client(over_budget, rng, monkeypatch):
    """The port picks the engine by the JAX client's rule, with its own
    copy of the constant, equal to the JAX client's. With both budgets set
    just below (or at) this DB's 4 * m * 1774 bytes of planes, both
    clients stream (or keep A resident), and give byte-identical query
    bytes for the same key and secrets, and the same s . A."""
    import chalametpir_tpu
    import chalametpir_tpu.models.client as jax_client_module
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator as JaxOverflow
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine as JaxEngine
    from chalametpir_tpu.ops.client_device import StreamingQueryEngine as JaxStreaming

    assert port_client_module.RESIDENT_PLANES_MAX_BYTES == jax_client_module.RESIDENT_PLANES_MAX_BYTES

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 48))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, prg_mode="ctr", rng=rng, device="cpu")
    m = server.num_query_cols
    budget = 4 * m * LWE_DIMENSION - (1 if over_budget else 0)
    monkeypatch.setattr(jax_client_module, "RESIDENT_PLANES_MAX_BYTES", budget)
    monkeypatch.setattr(port_client_module, "RESIDENT_PLANES_MAX_BYTES", budget)
    # the JAX engines generate A in small slabs here; the result cannot
    # depend on the slab width
    orig = JaxEngine.streaming_from_seed_ctr.__func__
    monkeypatch.setattr(JaxEngine, "streaming_from_seed_ctr",
                        classmethod(lambda cls, s, mm: orig(cls, s, mm, cols_per_step=512)))

    jax_client = chalametpir_tpu.Client.setup(seed, hint, fparams, prg_mode="ctr", device=True)
    port_client = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
    assert isinstance(jax_client._engine, JaxStreaming) == over_budget
    assert isinstance(port_client._engine, StreamingQueryEngine) == over_budget
    assert port_client.setup_stats["engine"] == ("streaming" if over_budget else "resident")

    codes = _codes(rng, 3)
    assert np.array_equal(port_client._engine.matvec_batch(codes),
                          jax_client._engine.matvec_batch(codes))
    for i, key in enumerate(list(db)[:3]):
        _deterministic_sampler(monkeypatch, 1000 + i)
        want = _query(jax_client, key, JaxOverflow)
        _deterministic_sampler(monkeypatch, 1000 + i)
        assert _query(port_client, key) == want
        assert port_client.process_response(key, server.respond(want)) == db[key]


def test_round_trip_through_streaming_client(rng, monkeypatch):
    """Client.setup past the budget streams A, and the whole protocol
    (single queries, the prepared pool, batches) decodes every value."""
    monkeypatch.setattr(port_client_module, "RESIDENT_PLANES_MAX_BYTES", 0)
    db = generate_random_kv_database(400, rng=rng, value_byte_len=(900, 1024))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, prg_mode="ctr", rng=rng, device="cpu")
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu", prepared_queries=2)
    assert isinstance(client._engine, StreamingQueryEngine) and client.uses_device
    assert client.setup_stats["engine"] == "streaming" and client.setup_stats["plane_bytes"] == 0
    keys = list(db)
    for key in keys[:3]:  # the first two come from the prepared pool
        assert client.process_response(key, server.respond(_query(client, key))) == db[key]
    batch = keys[3:8]
    for key, q in zip(batch, client.query_batch(batch)):
        assert client.process_response(key, server.respond(q)) == db[key]


@pytest.mark.cuda
def test_streaming_engine_on_cuda_matches_native_and_resident(cuda):
    from chalametpir_tpu_torch import kernels

    g = np.random.default_rng(12)
    m = 20011
    seed = g.bytes(32)
    codes = _codes(g, 5)
    before = kernels.LAUNCHES["ctr_keccak"]
    eng = StreamingQueryEngine(seed, m, device=cuda, cols_per_step=4096)
    got = eng.matvec_batch(codes)
    assert kernels.LAUNCHES["ctr_keccak"] == before + 5  # one K3 launch per slab
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="ctr")
    assert np.array_equal(got, np.stack([native.ternary_matvec(c, a) for c in codes]))
    assert np.array_equal(got, DeviceQueryEngine.from_seed_ctr(seed, m, device=cuda).matvec_batch(codes))


@pytest.mark.cuda
def test_resident_engine_that_does_not_fit_raises(cuda):
    """Asked for explicitly, resident planes past the free device memory
    raise (4 * 2^25 * 1776 B is more than any single card holds)."""
    with pytest.raises(AcceleratorError, match="StreamingQueryEngine"):
        DeviceQueryEngine.from_seed_ctr(bytes(32), 1 << 25, device=cuda)
