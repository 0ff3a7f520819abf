"""The client's benchmarking hooks, `discard_query` and `insert_query`
(reference: client.rs:60-71), and the package's public names: the port
(chalametpir_tpu_torch) against the JAX package, each case through both
clients on the same numpy-seeded DB. The port runs on device="cpu".

The JAX package is imported inside the tests and fixtures that use it."""

import numpy as np
import pytest
import torch

import chalametpir_tpu_torch
from chalametpir_tpu_torch.utils import generate_random_kv_database

torch.set_num_threads(1)

KINDS = ("jax", "torch")


class _Party:
    """One package's server and client over the shared DB, with its errors."""

    def __init__(self, kind: str, seed: bytes, db: dict):
        if kind == "jax":
            import chalametpir_tpu as pkg
            from chalametpir_tpu import errors

            self.server, hint, fparams = pkg.Server.setup(seed, db, arity=3, rng=np.random.default_rng(5))
            self.client = pkg.Client.setup(seed, hint, fparams, device=False)
        else:
            pkg = chalametpir_tpu_torch
            from chalametpir_tpu_torch import errors

            self.server, hint, fparams = pkg.Server.setup(seed, db, arity=3, rng=np.random.default_rng(5),
                                                          device="cpu")
            self.client = pkg.Client.setup(seed, hint, fparams, device="cpu")
        self.Query, self.errors = pkg.Query, errors

    def query(self, key: bytes) -> bytes:
        while True:
            try:
                return self.client.query(key)
            except self.errors.ArithmeticOverflowAddingQueryIndicator:
                continue


@pytest.fixture(scope="module")
def parties():
    g = np.random.default_rng(20241)
    db = generate_random_kv_database(300, rng=g, value_byte_len=(4, 64))
    seed = g.bytes(32)
    return db, {kind: _Party(kind, seed, db) for kind in KINDS}


def _key(db: dict, i: int) -> bytes:
    return list(db)[i]


@pytest.mark.parametrize("kind", KINDS)
def test_discard_returns_the_query_once(kind, parties):
    db, both = parties
    party, key = both[kind], _key(db, 0)
    party.query(key)
    pending = party.client.discard_query(key)
    assert isinstance(pending, party.Query)
    assert pending.vec_c.dtype == np.uint32 and pending.vec_c.ndim == 1
    assert party.client.discard_query(key) is None
    assert party.client.discard_query(bytearray(key)) is None  # bytes(key) normalisation
    with pytest.raises(party.errors.PendingQueryDoesNotExistForKey):
        party.client.process_response(key, b"")


@pytest.mark.parametrize("kind", KINDS)
def test_insert_restores_the_query(kind, parties):
    db, both = parties
    party, key = both[kind], _key(db, 1)
    response = party.server.respond(party.query(key))
    pending = party.client.discard_query(key)
    with pytest.raises(party.errors.PendingQueryDoesNotExistForKey):
        party.client.process_response(key, response)
    party.client.insert_query(bytearray(key), pending)
    assert party.client.process_response(key, response) == db[key]
    assert party.client.discard_query(key) is None  # consumed by the response


def _corruptions(blob: bytes):
    yield "empty", b""
    yield "truncated", blob[: len(blob) // 2]
    yield "trailing", blob + b"\x00" * 8
    big = bytearray(blob)
    big[0:8] = (0xFFFFFFFF).to_bytes(4, "little") * 2  # huge dims
    yield "huge-dims", bytes(big)
    flip = bytearray(blob)
    flip[8 + 3] ^= 0xFF  # the top byte of the row's first element: inside the key digest
    yield "bit-flip", bytes(flip)


def _corrupt_outcomes(party, db, key) -> dict:
    """The loop of tests/test_pir_integration.py: discard, re-insert around
    each malformed response, then the genuine one; the outcome per
    corruption (the error's name, or "ok"), and whether the pending query
    survived it."""
    response = party.server.respond(party.query(key))
    pending = party.client.discard_query(key)
    outcomes = {}
    for name, bad in _corruptions(response):
        party.client.insert_query(key, pending)
        try:
            party.client.process_response(key, bad)
            outcome = "ok"
        except party.errors.ChalametPIRError as e:
            outcome = type(e).__name__
        survived = party.client.discard_query(key) is not None
        outcomes[name] = (outcome, survived)
    party.client.insert_query(key, pending)
    assert party.client.process_response(key, response) == db[key]
    return outcomes


@pytest.mark.parametrize("kind", KINDS)
def test_corrupt_responses_leave_the_restored_query_usable(kind, parties):
    db, both = parties
    outcomes = _corrupt_outcomes(both[kind], db, _key(db, 2))
    # structurally invalid bytes leave the pending query (client.rs:210-217);
    # a parseable but corrupt response consumes it (client.rs:267)
    for name in ("empty", "truncated", "trailing", "huge-dims"):
        assert outcomes[name] == ("InvalidResponseVector", True), name
    assert outcomes["bit-flip"][0] in ("RowNotDecodable", "DecodedRowNotPrependedWithDigestOfKey")
    assert outcomes["bit-flip"][1] is False


def test_corrupt_responses_same_outcome_in_both_clients(parties):
    db, both = parties
    key = _key(db, 3)
    assert _corrupt_outcomes(both["jax"], db, key) == _corrupt_outcomes(both["torch"], db, key)


@pytest.mark.parametrize("kind", KINDS)
def test_query_on_a_reinserted_key_raises(kind, parties):
    db, both = parties
    party, key = both[kind], _key(db, 4)
    response = party.server.respond(party.query(key))
    pending = party.client.discard_query(key)
    party.client.insert_query(key, pending)
    with pytest.raises(party.errors.PendingQueryExistsForKey):
        party.client.query(key)
    with pytest.raises(party.errors.PendingQueryExistsForKey):
        party.client.query_batch([key])
    assert party.client.process_response(key, response) == db[key]


@pytest.mark.parametrize("kind", KINDS)
def test_a_reservation_is_never_handed_out(kind, parties):
    """A key reserved by a query() still in flight reads as no pending
    query: discard_query returns None, never the reservation token."""
    db, both = parties
    party, key = both[kind], _key(db, 5)
    token = party.client._reserve_pending(key)
    assert not isinstance(token, party.Query)
    assert party.client.discard_query(key) is None
    party.client._release_reservation(key, token)
    response = party.server.respond(party.query(key))  # the key is free again
    assert party.client.process_response(key, response) == db[key]


def test_port_discard_keeps_a_reservation_in_place(parties):
    """The port's discard_query takes the pending lock and leaves another
    thread's reservation where it is, so that thread's query() still
    finalizes against its own claim."""
    db, both = parties
    client, key = both["torch"].client, _key(db, 6)
    token = client._reserve_pending(key)
    assert client.discard_query(key) is None
    assert client._pending[key] is token
    with pytest.raises(both["torch"].errors.PendingQueryExistsForKey):
        client.query(key)
    client._release_reservation(key, token)
    assert key not in client._pending


# chalametpir_tpu.__all__, written out: the JAX package is imported inside tests only
JAX_PUBLIC_NAMES = ["Server", "Client", "Query", "BinaryFuseFilter", "ChalametPIRError",
                    "SEED_BYTE_LEN", "LWE_DIMENSION"]


@pytest.mark.parametrize("name", JAX_PUBLIC_NAMES)
def test_port_exports_the_jax_package_surface(name):
    import chalametpir_tpu

    assert sorted(chalametpir_tpu.__all__) == sorted(JAX_PUBLIC_NAMES)
    assert name in chalametpir_tpu_torch.__all__
    ours = getattr(chalametpir_tpu_torch, name)
    assert ours is not None
    if name in ("SEED_BYTE_LEN", "LWE_DIMENSION"):
        assert ours == getattr(chalametpir_tpu, name)
    else:
        assert isinstance(ours, type) and ours.__module__.startswith("chalametpir_tpu_torch.")
