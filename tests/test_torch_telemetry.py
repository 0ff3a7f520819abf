"""The port's spans on the CPU (utils/telemetry.py): what a lookup round,
a batch, a prepared query, an overflow, the ctr set-up and the TCP
dispatcher record, that nothing is kept or timed while recording is off,
that no span holds a key or an array or waits on the device, and the
buffer's bound."""

import asyncio

import numpy as np
import pytest
import torch

import chalametpir_tpu_torch.models.client as client_mod
import chalametpir_tpu_torch.models.server as server_mod
from chalametpir_tpu_torch import Client, Server, kernels
from chalametpir_tpu_torch.core import prg
from chalametpir_tpu_torch.errors import ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu_torch.net.server import BatchDispatcher
from chalametpir_tpu_torch.ops import client_device
from chalametpir_tpu_torch.params import LWE_DIMENSION
from chalametpir_tpu_torch.utils import generate_random_kv_database, telemetry

torch.set_num_threads(1)

QUERY_CHILDREN = ["client.query.secret", "client.query.launch", "client.query.error", "client.query.unblind",
                  "client.query.wait", "client.query.indicator", "client.query.serialize"]
RESPOND_CHILDREN = ["server.respond.parse", "server.respond_batch", "server.respond.serialize"]
BATCH_CHILDREN = ["server.respond_batch.upload", "server.respond_batch.kernel", "server.respond_batch.readback"]
ENCODE_CHILDREN = ["encode_stream.listify", "encode_stream.hash", "encode_stream.filter", "encode_stream.vscan",
                   "encode_stream.plan", "encode_stream.alloc"]


@pytest.fixture(scope="module")
def pir():
    """A 2^10-entry ctr DB and two clients: the resident engine and the
    streaming one (the resident budget at 0, as the benchmark's CPU runs
    drive it)."""
    rng = np.random.default_rng(16)
    db = generate_random_kv_database(1 << 10, rng=rng, value_byte_len=(1, 32))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, prg_mode="ctr", rng=rng, device="cpu")
    clients = {"resident": Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(client_mod, "RESIDENT_PLANES_MAX_BYTES", 0)
        clients["streaming"] = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
    assert clients["streaming"].setup_stats["engine"] == "streaming"
    return server, clients, list(db), db


@pytest.fixture
def recording():
    telemetry.start_recording()
    try:
        yield
    finally:
        telemetry.stop_recording()
        telemetry.take_spans()


def query(client, key):
    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue


def one_round(client, server, key):
    """A round that overflowed nothing: the spans of its last query()
    attempt, respond and process_response."""
    while True:
        telemetry.take_spans()
        try:
            q = client.query(key)
            break
        except ArithmeticOverflowAddingQueryIndicator:
            continue
    value = client.process_response(key, server.respond(q))
    return value, telemetry.take_spans()


def children(spans, parent):
    return [s for s in sorted(spans, key=lambda s: s.start) if s.parent == parent.id]


def only(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, [s.name for s in spans])
    return found[0]


@pytest.mark.parametrize("engine", ["resident", "streaming"])
def test_a_lookup_round_records_the_span_tree(pir, recording, engine):
    server, clients, keys, db = pir
    client = clients[engine]
    value, spans = one_round(client, server, keys[3])
    assert value == db[keys[3]]
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in sorted(roots, key=lambda s: s.start)] == [
        "client.query", "server.respond", "client.process_response"]
    for root in roots:
        assert root.request == root.id and root.error is None
    q = only(spans, "client.query")
    assert [s.name for s in children(spans, q)] == QUERY_CHILDREN
    r = only(spans, "server.respond")
    assert [s.name for s in children(spans, r)] == RESPOND_CHILDREN
    rb = only(spans, "server.respond_batch")
    assert [s.name for s in children(spans, rb)] == BATCH_CHILDREN
    for s in spans:  # one request id per root, shared by its whole tree
        root = s
        while root.parent is not None:
            root = next(p for p in spans if p.id == root.parent)
        assert s.request == root.id
        assert root.start <= s.start <= s.end <= root.end
    # the bytes that crossed: s.A's row read back, the query uploaded, the answer read back
    read = np.asarray(client._engine.matvec_batch_async(np.zeros((1, LWE_DIMENSION), np.int8)))
    assert only(spans, "client.query.wait").fields == {"bytes": read.nbytes}
    assert only(spans, "server.respond_batch.upload").fields == {"bytes": 4 * server.num_query_cols}
    assert only(spans, "server.respond_batch.readback").fields == {"bytes": 4 * server.num_response_cols}
    assert rb.fields == {"queries": 1}


# the engine launches the fused kernel once per kernels.SA_MAX_Q secrets,
# whatever cols_per_step; the first three cases keep their old ids
@pytest.mark.parametrize("cols_per_step,q", [
    pytest.param(128, kernels.SA_MAX_Q + 1, id="128"),
    pytest.param(336, 2 * kernels.SA_MAX_Q + 1, id="336"),
    pytest.param(1 << 16, kernels.SA_MAX_Q + 1, id="65536"),
    pytest.param(336, 2, id="fused-2"),
    pytest.param(336, kernels.SA_MAX_Q, id="fused-SA_MAX_Q"),
])
def test_the_launch_counts_the_slabs_the_streaming_engine_dispatched(pir, recording, monkeypatch, cols_per_step, q):
    server, clients, keys, db = pir
    base = clients["streaming"]
    m = base._filter.num_fingerprints
    engine = client_device.StreamingQueryEngine(base._seed, m, cols_per_step, "cpu")
    client = Client(None, base._hint_mat_m, base._filter, engine, base._seed, "ctr")
    dispatched, fused = [], []
    expand, sa = client_device.prg_torch.expand_fp_slab, client_device.prg_torch.ctr_sa

    def counted(*args, **kwargs):
        dispatched.append(args[1])
        return expand(*args, **kwargs)

    def counted_sa(*args, **kwargs):
        fused.append(args[1].shape[0])
        return sa(*args, **kwargs)

    monkeypatch.setattr(client_device.prg_torch, "expand_fp_slab", counted)
    monkeypatch.setattr(client_device.prg_torch, "ctr_sa", counted_sa)
    value, spans = one_round(client, server, keys[5])
    assert value == db[keys[5]]
    assert only(spans, "client.query.launch").fields == {"fused": 1}
    assert dispatched == [] and fused and set(fused) == {1}
    batch = keys[30 : 30 + q]
    while True:
        telemetry.take_spans()
        del fused[:]
        try:
            sent = client.query_batch(batch)
            break
        except ArithmeticOverflowAddingQueryIndicator:
            continue
    launches = [s for s in telemetry.take_spans() if s.name == "client.query.launch"]
    # the batch's own launch first; an overflow's retry adds a lookup's
    assert launches[0].fields == {"fused": -(-q // kernels.SA_MAX_Q)}
    assert all(s.fields == {"fused": 1} for s in launches[1:])
    assert dispatched == [] and fused[0] == q and set(fused[1:]) <= {1}
    for key, sent_q in zip(batch, sent):
        assert client.process_response(key, server.respond(sent_q)) == db[key]


def test_the_launch_counts_no_slabs_for_the_resident_and_host_engines(pir, recording):
    server, clients, keys, db = pir
    _, spans = one_round(clients["resident"], server, keys[6])
    assert only(spans, "client.query.launch").fields == {"fused": 0}
    base = clients["resident"]
    host = Client(prg.expand_seed(LWE_DIMENSION, base._filter.num_fingerprints, base._seed, mode="ctr"),
                  base._hint_mat_m, base._filter, None, base._seed, "ctr")
    assert not host.uses_device
    value, spans = one_round(host, server, keys[7])
    assert value == db[keys[7]]
    assert only(spans, "client.query.launch").fields == {"fused": 0}


def test_query_batch_and_the_pool_record_their_children(pir, recording):
    server, clients, keys, db = pir
    client = clients["resident"]
    batch = keys[10:13]
    while True:
        telemetry.take_spans()
        try:
            sent = client.query_batch(batch)
            break
        except ArithmeticOverflowAddingQueryIndicator:
            continue
    spans = telemetry.take_spans()
    root = only(spans, "client.query")
    assert root.fields == {"queries": 3}
    names = [s.name for s in children(spans, root)]
    assert names[:2] == ["client.query.secret", "client.query.launch"]
    # per key, the finalize children; an overflow's retry adds its own secret and launch
    for name in QUERY_CHILDREN[2:]:
        assert names.count(name) >= 3
    for key, q in zip(batch, sent):
        assert client.process_response(key, server.respond(q)) == db[key]

    client.prepare_queries(1)
    key = keys[20]
    while True:
        telemetry.take_spans()
        try:
            q = client.query(key)
            break
        except ArithmeticOverflowAddingQueryIndicator:
            client.prepare_queries(1)
    spans = telemetry.take_spans()
    root = only(spans, "client.query")
    assert [s.name for s in children(spans, root)] == ["client.query.indicator", "client.query.serialize"]
    assert client.process_response(key, server.respond(q)) == db[key]


def test_an_indicator_overflow_is_recorded_as_the_query_error(pir, recording, monkeypatch):
    server, clients, keys, _ = pir
    client = clients["resident"]
    real = client._add_query_indicator

    def at_the_top(query_b, key):
        query_b[:] = 0xFFFFFFFF  # every filter row overflows, in the real check
        return real(query_b, key)

    monkeypatch.setattr(client, "_add_query_indicator", at_the_top)
    telemetry.take_spans()
    with pytest.raises(ArithmeticOverflowAddingQueryIndicator):
        client.query(keys[5])
    spans = telemetry.take_spans()
    assert only(spans, "client.query").error == "ArithmeticOverflowAddingQueryIndicator"
    assert only(spans, "client.query.indicator").error == "ArithmeticOverflowAddingQueryIndicator"
    assert "client.query.serialize" not in {s.name for s in spans}
    assert client.discard_query(keys[5]) is None  # the reservation was released


def test_off_records_nothing_and_returns_one_shared_object(pir):
    server, clients, keys, db = pir
    telemetry.stop_recording()
    telemetry.take_spans()
    assert not telemetry.trace_enabled()
    first = telemetry.span("client.query")
    assert all(telemetry.span(name, bytes=1) is first for name in QUERY_CHILDREN)
    with first as inside:
        inside.set(bytes=3)
    telemetry.add_span("net.queue_wait", 0.0, 1.0, batch=0)
    key = keys[7]
    assert clients["resident"].process_response(
        key, server.respond(query(clients["resident"], key))) == db[key]
    assert telemetry.take_spans() == [] and telemetry.dropped_spans() == 0


def test_no_span_holds_a_key_a_secret_or_an_array(pir, recording):
    server, clients, keys, _ = pir
    key = keys[9]
    _, spans = one_round(clients["streaming"], server, key)
    assert spans
    for s in spans:
        assert all(type(v) in (int, float) for v in s.fields.values()), s
        assert set(s.fields) <= {"bytes", "fused", "queries"}
        assert isinstance(s.error, (str, type(None))) and isinstance(s.name, str)
        assert repr(key)[2:-1] not in repr(s)
    with pytest.raises(TypeError):
        telemetry.span("client.query", key=key)
    with pytest.raises(TypeError):
        telemetry.add_span("client.query", 0.0, 1.0, words=np.zeros(4, np.uint32))


def test_no_span_waits_on_the_device(pir, recording, monkeypatch):
    server, clients, keys, db = pir
    waits = []

    def counted(*args, **kwargs):
        waits.append(args)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    monkeypatch.setattr(client_device.DeviceResult, "block_until_ready", counted)
    for engine in ("resident", "streaming"):
        value, spans = one_round(clients[engine], server, keys[11])
        assert value == db[keys[11]] and len(spans) == 16
    assert waits == []


def test_ctr_setup_records_the_encode_and_one_chunk_set_per_chunk(recording, monkeypatch):
    monkeypatch.setattr(server_mod, "_CTR_CHUNK_COLS", 2048)  # several chunks at 2^12 entries
    rng = np.random.default_rng(3)
    db = generate_random_kv_database(1 << 12, rng=rng, value_byte_len=(1, 8))
    telemetry.take_spans()
    server, _, _ = Server.setup(rng.bytes(32), db, prg_mode="ctr", rng=rng, device="cpu")
    spans = telemetry.take_spans()
    encode = only(spans, "server_setup.encode_stream")
    assert encode.parent is None and encode.fields["entries"] == 1 << 12
    assert [s.name for s in children(spans, encode)] == ENCODE_CHILDREN
    pipeline = only(spans, "server_setup.stream_pack_upload_fold")
    n = server.planes.lo.shape[0] // 2048
    assert n >= 2 and pipeline.fields["chunks"] == n
    chunk = {name: [s for s in children(spans, pipeline) if s.name == "server_setup.chunk." + name]
             for name in ("wait", "pack", "put", "fold")}
    # one set a chunk, and the last wait: the encode worker's end
    assert [len(chunk[k]) for k in ("wait", "pack", "put", "fold")] == [n + 1, n, n, n]
    phases = server.setup_stats["phases_s"]
    assert {"wait", "pack", "pack_cpu", "put", "dispatch", "drain"} <= set(phases)
    for key, name in (("wait", "wait"), ("pack", "pack"), ("put", "put"), ("dispatch", "fold")):
        assert phases[key] == round(sum(s.end - s.start for s in chunk[name]), 2)
    assert abs(phases["encode"] - (encode.end - encode.start)) < 0.006
    order = sorted(chunk["pack"] + chunk["put"] + chunk["fold"], key=lambda s: s.start)
    assert [s.name.rsplit(".", 1)[1] for s in order] == ["pack", "put", "fold"] * n


def test_the_dispatcher_links_each_queue_wait_to_its_batch(pir, recording):
    server, clients, keys, db = pir
    client = clients["resident"]
    batch = keys[30:33]
    sent = [query(client, key) for key in batch]
    telemetry.take_spans()
    dispatcher = BatchDispatcher(server, max_batch=8)

    async def run():
        try:
            return await asyncio.gather(*(dispatcher.submit(q) for q in sent))
        finally:
            await dispatcher.aclose()

    answers = asyncio.run(run())
    for key, answer in zip(batch, answers):
        assert client.process_response(key, answer) == db[key]
    spans = telemetry.take_spans()
    waits = [s for s in spans if s.name == "net.queue_wait"]
    batches = {s.fields["batch"]: s for s in spans if s.name == "net.batch"}
    assert len(waits) == 3 and len([s for s in spans if s.name == "net.submit.parse"]) == 3
    assert sum(b.fields["rows"] for b in batches.values()) == 3
    for w in waits:
        b = batches[w.fields["batch"]]
        assert w.start <= w.end <= b.start
    for b in batches.values():
        assert [s.name for s in children(spans, b)] == ["net.batch.stack", "net.batch.respond",
                                                         "net.batch.serialize"]
        respond = children(spans, b)[1]
        # the worker thread's respond_batch is a child of the awaiting span
        (inner,) = [s for s in spans if s.name == "server.respond_batch" and s.parent == respond.id]
        assert inner.request == b.request and inner.fields == {"queries": b.fields["rows"]}


def test_the_buffer_keeps_its_bound_and_counts_the_rest(monkeypatch, capsys):
    monkeypatch.setattr(telemetry, "MAX_SPANS", 3)
    telemetry.start_recording()
    try:
        with telemetry.span("outer", rows=2):
            for i in range(4):
                telemetry.add_span("inner", float(i), float(i) + 0.5, batch=i)
        kept = telemetry.take_spans()
        assert [s.name for s in kept] == ["inner"] * 3 and telemetry.dropped_spans() == 2
        assert all(s.parent == kept[0].parent for s in kept) and kept[0].parent is not None
        with telemetry.span("again"):
            pass
        assert [s.name for s in telemetry.take_spans()] == ["again"] and telemetry.dropped_spans() == 2
        telemetry.set_trace(True)
        with telemetry.span("printed", rows=1):
            pass
        telemetry.add_span("printed.too", 0.0, 0.25)
    finally:
        telemetry.set_trace(False)
        telemetry.stop_recording()
        telemetry.take_spans()
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("[trace] printed: ") and err[0].endswith("s rows=1")
    assert err[1] == "[trace] printed.too: 0.250s"
    telemetry.start_recording()
    telemetry.stop_recording()
    assert telemetry.dropped_spans() == 0
