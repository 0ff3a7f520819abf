"""The query's error vector: the native in-place add of the ternary codes
into s . A (`native.engine.add_ternary_u32`) against the numpy words it
replaced, the wrapper's checks, and, through the real CSPRNG on a small
CPU client, that every wire word carries exactly one ternary error term
drawn by `Client._sample_ternary` in its fixed order."""

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.core import hashing, matrix_io
from chalametpir_tpu_torch.core.filter import hash_batch
from chalametpir_tpu_torch.errors import ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu_torch.models import client as client_module
from chalametpir_tpu_torch.native import engine as native
from chalametpir_tpu_torch.params import LWE_DIMENSION
from chalametpir_tpu_torch.utils import generate_random_kv_database

torch.set_num_threads(1)


def _numpy_error_words(codes: np.ndarray) -> np.ndarray:
    """The u32 error vector as the client built it before the native add:
    a zero fill and two masked stores."""
    out = np.zeros(codes.shape[0], np.uint32)
    out[codes == 1] = 1
    out[codes == 2] = 0xFFFFFFFF
    return out


@pytest.mark.parametrize("m", [1, 17, (1 << 20) + 3])
def test_add_ternary_u32_matches_the_numpy_words(m, rng):
    b = rng.integers(0, 1 << 32, size=m, dtype=np.uint32)
    codes = rng.integers(0, 3, size=m).astype(np.int8)
    # both wraps: 0 - 1 and 0xFFFFFFFF + 1
    b[0], codes[0] = 0, 2
    if m > 1:
        b[-1], codes[-1] = 0xFFFFFFFF, 1
    want = b + _numpy_error_words(codes)
    native.add_ternary_u32(b, codes)
    assert b.dtype == np.uint32
    assert np.array_equal(b, want)


@pytest.mark.parametrize(
    "b, codes",
    [
        (np.zeros(8, np.uint32), np.zeros(7, np.int8)),
        (np.zeros(8, np.uint32), np.zeros(9, np.int8)),
        (np.zeros(8, np.uint32), np.zeros(8, np.uint8)),
        (np.zeros(8, np.uint32), np.zeros(8, np.int32)),
        (np.zeros(8, np.int32), np.zeros(8, np.int8)),
        (np.zeros(8, np.uint64), np.zeros(8, np.int8)),
        (np.zeros(16, np.uint32)[::2], np.zeros(8, np.int8)),
        (np.zeros(8, np.uint32), np.zeros(16, np.int8)[::2]),
    ],
    ids=["short-codes", "long-codes", "uint8-codes", "int32-codes", "int32-b",
         "uint64-b", "strided-b", "strided-codes"],
)
def test_add_ternary_u32_rejects_what_c_cannot_read(b, codes):
    before = b.copy()
    with pytest.raises(ValueError):
        native.add_ternary_u32(b, codes)
    assert np.array_equal(b, before)


def test_add_ternary_u32_rejects_a_read_only_b():
    b = np.zeros(8, np.uint32)
    b.flags.writeable = False
    with pytest.raises(ValueError):
        native.add_ternary_u32(b, np.ones(8, np.int8))


@pytest.fixture(scope="module")
def pir():
    rng = np.random.default_rng(17)
    db = generate_random_kv_database(3000, rng=rng, value_byte_len=(1, 16))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, arity=3, prg_mode="ctr", rng=np.random.default_rng(3), device="cpu"
    )
    clients = {
        "device": Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu"),
        "host": Client.setup(seed, hint, fparams, prg_mode="ctr", device=False),
    }
    return server, clients, sorted(db), db


class _Recorder:
    """Wraps Client._sample_ternary: the real CSPRNG, every draw kept."""

    def __init__(self, monkeypatch):
        self.draws: list[np.ndarray] = []
        real = client_module.Client._sample_ternary

        def sample(n):
            codes = real(n)
            self.draws.append(codes.copy())
            return codes

        monkeypatch.setattr(client_module.Client, "_sample_ternary", staticmethod(sample))

    def query(self, client, key):
        """client.query(key), retried on the indicator overflow; returns the
        wire bytes and the draws of the attempt that succeeded."""
        while True:
            self.draws.clear()
            try:
                sent = client.query(key)
            except ArithmeticOverflowAddingQueryIndicator:
                continue
            return sent, list(self.draws)


def _filter_rows(client, key) -> set[int]:
    filt = client._filter
    fused = int(hashing.mix256(hashing.hash_of_key(key), filt.seed))
    rows = hash_batch(filt.arity, np.uint64(fused), filt.segment_length, filt.segment_count_length)
    return {int(r) for r in rows}


def _s_dot_a(client, secret: np.ndarray, m: int) -> np.ndarray:
    return np.asarray(client._engine.matvec_batch_async(secret[None, :]))[0, :m]


@pytest.mark.parametrize("engine", ["device", "host"])
def test_query_draws_the_secret_then_the_error(pir, monkeypatch, engine):
    """One inline query calls the sampler exactly twice: n = LWE_DIMENSION
    for the secret, then n = m for the error, in that order."""
    _, clients, keys, _ = pir
    client = clients[engine]
    m = client._filter.num_fingerprints
    recorder = _Recorder(monkeypatch)
    _, draws = recorder.query(client, keys[0])
    assert [d.shape[0] for d in draws] == [LWE_DIMENSION, m]
    client.discard_query(keys[0])


@pytest.mark.parametrize("engine", ["device", "host"])
def test_wire_words_carry_one_ternary_error_each(pir, monkeypatch, engine):
    """With the real CSPRNG, each query's words minus s . A are the error
    codes exactly (0, +1, -1 mod 2^32) everywhere but the key's filter
    rows, and the three values each take a third of the words: an error
    left out or added twice cannot pass."""
    server, clients, keys, db = pir
    client = clients[engine]
    m = client._filter.num_fingerprints
    recorder = _Recorder(monkeypatch)
    counts = np.zeros(3, np.int64)
    total = 0
    for key in keys[1 : 1 + -(-30_000 // m)]:
        sent, (secret, error) = recorder.query(client, key)
        words = matrix_io.matrix_from_bytes(sent)[0]
        assert words.dtype == np.uint32 and words.shape == (m,)
        diff = words - _s_dot_a(client, secret, m)
        keep = np.ones(m, bool)
        keep[sorted(_filter_rows(client, key))] = False
        want = _numpy_error_words(error)
        assert np.array_equal(diff[keep], want[keep])
        assert set(np.unique(diff[keep]).tolist()) <= {0, 1, 0xFFFFFFFF}
        counts += [np.count_nonzero(diff[keep] == v) for v in (0, 1, 0xFFFFFFFF)]
        total += int(keep.sum())
        assert client.process_response(key, server.respond(sent)) == db[key]
    assert total >= 30_000
    assert np.all(np.abs(counts / total - 1 / 3) <= 0.02), counts / total


@pytest.mark.parametrize("engine", ["device", "host"])
def test_pool_entries_carry_one_ternary_error_each(pir, monkeypatch, engine):
    """prepare_queries draws every secret, then every error, and each pooled
    query's words are s . A plus its own error (off the filter rows)."""
    server, clients, keys, db = pir
    client = clients[engine]
    m = client._filter.num_fingerprints
    recorder = _Recorder(monkeypatch)
    count = 3
    client.prepare_queries(count)
    draws = recorder.draws
    assert [d.shape[0] for d in draws] == [LWE_DIMENSION] * count + [m] * count
    matched = []
    for key in keys[-count:]:
        while True:  # an overflow spends a pool entry; a later try may run inline
            try:
                sent = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                continue
        # the pool's (secret, error) pairs, then those of any inline retry
        pairs = list(zip(draws[:count], draws[count : 2 * count]))
        pairs += list(zip(draws[2 * count :: 2], draws[2 * count + 1 :: 2]))
        words = matrix_io.matrix_from_bytes(sent)[0]
        keep = np.ones(m, bool)
        keep[sorted(_filter_rows(client, key))] = False
        hits = [
            i for i, (secret, error) in enumerate(pairs)
            if np.array_equal((words - _s_dot_a(client, secret, m))[keep],
                              _numpy_error_words(error)[keep])
        ]
        assert len(hits) == 1
        matched += hits
        assert client.process_response(key, server.respond(sent)) == db[key]
    assert len(set(matched)) == count
