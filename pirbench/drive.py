"""The one traffic generator: drives a mix's "kind" with its parameters.

A mix is a data file, pirbench/traffic/<name>.json; its "kind" names one
of the drivers below, and the rest are that driver's parameters:

- "lookup": one client in a closed loop (a round is client.query(key)
  with no prepared pool, server.respond, client.process_response; a
  retry after the protocol's indicator overflow stays in its round).
  Keys are drawn from the seed without replacement. "warm_rounds" rounds
  come before the window; "kept" rounds, drawn from the seed, keep their
  query and answer for the check.
- "tcp": the program's PirTcpServer on 127.0.0.1, with "max_batch",
  serves "connections" closed-loop connections opened by "processes"
  load generators (pirbench/loadgen.py, which never touch the card). The
  first query of each connection is a real one, made at set-up by the
  program's client for a distinct key, and its answer is decoded after
  the window; in the window the connections send uniform queries. Each
  connection keeps "kept" answers, drawn from the seed.
- "batch": a front end calls server.respond_batch on "batch" distinct
  queries, back to back, from a ring of "ring" batches made at set-up:
  row 0 of each is a real query for a distinct key, made by the
  program's client, and the others are uniform, drawn from the seed, with
  word 0 rewritten to the call's number on each use. "warm_calls" calls
  come before the window; "kept" rows and "kept" answers to real queries,
  drawn from the seed, are kept: the rows for the check, the real answers
  to be decoded after the window.

Each driver does its set-up, calls ctx.setup_done() when the window opens,
runs the window for ctx.seconds inside trace.window, and fills the run's
counts, end-to-end values and the outputs that the check compares.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import struct
import sys
import time
import traceback

import numpy as np

from . import loadgen, trace

TRAFFIC = 2  # the seed's stream of the traffic's draws
KEPT = 6  # the seed's stream of the kept samples


def reservoir(rng: np.random.Generator, kept: list, size: int, seen: int, item) -> None:
    """Keep `item`, the seen-th of a stream, in a uniform sample of `size`."""
    if len(kept) < size:
        kept.append(item)
        return
    j = int(rng.integers(0, seen + 1))
    if j < size:
        kept[j] = item


def p95(samples: list[float]) -> float:
    """The nearest-rank 95th percentile of all samples."""
    ordered = sorted(samples)
    return ordered[-(-95 * len(ordered) // 100) - 1]


def query_with_retry(client, key: bytes) -> bytes:
    from chalametpir_tpu_torch import ArithmeticOverflowAddingQueryIndicator

    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue


def client_for(ctx):
    """The program's client, which must choose the configuration's engine.
    Client.setup's seconds, to the end of the device work it launched, go
    in ctx.counters["client_setup_s"]."""
    import torch
    from chalametpir_tpu_torch import Client

    if ctx.cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    client = Client.setup(ctx.pir_seed, ctx.hint, ctx.fparams, prg_mode=ctx.cfg["prg_mode"], device=ctx.dev)
    if ctx.cuda:
        torch.cuda.synchronize()
    ctx.counters["client_setup_s"] = time.perf_counter() - t0
    engine = client.setup_stats.get("engine")
    if engine != ctx.cfg["client_engine"]:
        raise RuntimeError(f"the client chose the {engine} engine; the configuration states "
                           f"{ctx.cfg['client_engine']}")
    return client


def report_failure(what: str) -> None:
    print(f"[pirbench] {what} failed:", file=sys.stderr)
    traceback.print_exc()


def lookup(ctx) -> None:
    mix = ctx.mix
    client = ctx.hold(client=client_for(ctx))
    server, spans = ctx.server, ctx.spans
    order = np.random.default_rng([ctx.seed, TRAFFIC]).permutation(ctx.n)
    keep_rng = np.random.default_rng([ctx.seed, KEPT])
    keys = ctx.key_list

    def round_(i: int, sample: list | None):
        k = int(order[i % ctx.n])
        key = keys[k]
        with spans.span("pirbench.query"):
            qb = query_with_retry(client, key)
        with spans.span("pirbench.respond"):
            rb = server.respond(qb)
        with spans.span("pirbench.process_response"):
            value = client.process_response(key, rb)
        if sample is not None:
            reservoir(keep_rng, sample, mix["kept"], i - mix["warm_rounds"], (qb, rb))
        return k, value

    results = []
    for i in range(mix["warm_rounds"]):
        try:
            results.append(round_(i, None))
        except Exception:  # its value is checked as missing
            report_failure("a warm round")
            results.append((int(order[i]), None))
            client.discard_query(keys[int(order[i])])
    spans.rows.clear()
    rounds, sample = [], []
    failed = 0
    i = mix["warm_rounds"]
    ctx.setup_done()
    with trace.window(spans, ctx.trace, ctx.cuda) as win:
        deadline = win["start"] + ctx.seconds
        while True:
            t0 = time.perf_counter()
            try:
                results.append(round_(i, sample))
            except Exception:  # a failed request is counted, and the window goes on
                if not failed:
                    report_failure("a round")
                failed += 1
                client.discard_query(keys[int(order[i % ctx.n])])
            t1 = time.perf_counter()
            rounds.append(t1 - t0)
            i += 1
            if t1 >= deadline:
                break
    ctx.win, ctx.window_s = win, win["end"] - win["start"]
    ctx.attempted, ctx.failed = len(rounds), failed
    ctx.e2e = {"round_trip_ms": ctx.window_s / len(rounds) * 1e3, "round_trip_p95_ms": p95(rounds) * 1e3}
    ctx.values = results
    ctx.kept = [(wire_row(q), wire_row(r)) for q, r in sample]


def wire_row(data: bytes) -> np.ndarray:
    rows, cols = struct.unpack_from("<II", data)
    return np.frombuffer(data, "<u4", offset=8, count=rows * cols)


def batch(ctx) -> None:
    import torch

    mix, server, spans = ctx.mix, ctx.server, ctx.spans
    q, m = mix["batch"], server.num_query_cols
    gen = torch.Generator(device=ctx.dev)
    gen.manual_seed(ctx.seed ^ 0x9E3779B97F4A7C15)
    ring = [torch.randint(-(1 << 31), 1 << 31, (q, m), generator=gen, dtype=torch.int32, device=ctx.dev)
            .cpu().numpy().view(np.uint32) for _ in range(mix["ring"])]
    # row 0 of each batch is a real query for a distinct key, whose answers
    # are decoded after the window; the other rows are uniform
    client = ctx.hold(client=client_for(ctx))
    real = [int(k) for k in np.random.default_rng([ctx.seed, TRAFFIC]).choice(ctx.n, size=len(ring), replace=False)]
    held = []
    for rows, k in zip(ring, real):
        rows[0] = wire_row(query_with_retry(client, ctx.key_list[k]))
        held.append(client.discard_query(ctx.key_list[k]))
    keep_rng = np.random.default_rng([ctx.seed, KEPT])

    def call(i: int) -> np.ndarray:
        rows = ring[i % len(ring)]
        rows[1:, 0] = i
        with spans.span("pirbench.respond_batch", q):
            return server.respond_batch(rows)

    for i in range(mix["warm_calls"]):
        call(i)
    spans.rows.clear()
    sample, real_sample, failed, calls = [], [], 0, 0
    i = mix["warm_calls"]
    ctx.setup_done()
    with trace.window(spans, ctx.trace, ctx.cuda) as win:
        deadline = win["start"] + ctx.seconds
        while True:
            try:
                out = call(i)
                if out.shape != (q, server.num_response_cols):
                    raise RuntimeError(f"respond_batch answered {out.shape} for {q} queries")
                for r in range(q):
                    reservoir(keep_rng, sample, mix["kept"], calls * q + r, (i, r, out[r].copy()))
                reservoir(keep_rng, real_sample, mix["kept"], calls, (i % len(ring), out[0].copy()))
            except Exception:  # a failed call leaves its queries unanswered
                if not failed:
                    report_failure("a respond_batch call")
                failed += q
            calls += 1
            i += 1
            if time.perf_counter() >= deadline:
                break
    ctx.win, ctx.window_s = win, win["end"] - win["start"]
    ctx.attempted, ctx.failed = calls * q, failed
    ctx.e2e = {"serve_qps": (ctx.attempted - failed) / ctx.window_s}

    def query(i: int, r: int) -> np.ndarray:
        row = ring[i % len(ring)][r].copy()
        if r:
            row[0] = i
        return row

    ctx.kept = [(query(i, r), out) for i, r, out in sample]
    ctx.values = []
    header = struct.pack("<II", 1, server.num_response_cols)
    for j, answer in real_sample:
        key = ctx.key_list[real[j]]
        client.insert_query(key, held[j])
        try:
            ctx.values.append((real[j], client.process_response(key, header + answer.tobytes())))
        except Exception:  # an answer the client cannot decode is a wrong value
            ctx.values.append((real[j], None))
            client.discard_query(key)


def tcp(ctx) -> None:
    from chalametpir_tpu_torch.net.server import PirTcpServer

    mix, server, spans = ctx.mix, ctx.server, ctx.spans
    client = ctx.hold(client=client_for(ctx))
    conns, procs_n = mix["connections"], mix["processes"]
    draw = np.random.default_rng([ctx.seed, TRAFFIC]).choice(ctx.n, size=conns, replace=False)
    real_keys = [int(k) for k in draw]
    reals = [query_with_retry(client, ctx.key_list[k]) for k in real_keys]
    m = server.num_query_cols

    def respond_batch(rows: np.ndarray) -> np.ndarray:
        with spans.span("pirbench.respond_batch", rows.shape[0]):
            return server.respond_batch(rows)

    for size in range(1, mix["max_batch"] + 1):  # every batch size the dispatcher can stack
        server.respond_batch(np.zeros((size, m), np.uint32))
    front = ctx.hold(tcp=PirTcpServer(server, ctx.pir_seed, ctx.hint, ctx.fparams, respond_batch_fn=respond_batch,
                                      max_batch=mix["max_batch"]))
    dispatcher = front._dispatcher
    loop = asyncio.new_event_loop()
    srv, procs = None, []
    limit = ctx.seconds + 120

    async def start() -> None:
        nonlocal srv
        srv = await asyncio.start_server(front.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        for p in range(procs_n):
            mine = list(range(p, conns, procs_n))
            proc = await asyncio.create_subprocess_exec(
                sys.executable, os.path.abspath(loadgen.__file__),
                stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE, limit=1 << 26)
            procs.append(proc)
            job = {"port": port, "m": m, "seed": ctx.seed, "conns": mine, "kept": mix["kept"]}
            proc.stdin.write(json.dumps(job).encode() + b"\n")
            for c in mine:
                proc.stdin.write(struct.pack("<I", len(reals[c])) + reals[c])
            await proc.stdin.drain()
        for proc in procs:
            if (await proc.stdout.readline()).strip() != b"ready":
                raise RuntimeError("a load generator failed before the window")

    async def run_window() -> list:
        for proc in procs:
            proc.stdin.write(f"go {ctx.seconds}\n".encode())
            await proc.stdin.drain()
        lines = await asyncio.gather(*[proc.stdout.readline() for proc in procs])
        if not all(lines):
            raise RuntimeError("a load generator ended without its report")
        return [json.loads(line) for line in lines]

    async def stop() -> None:
        if srv is not None:
            srv.close()
        await dispatcher.aclose()
        for proc in procs:
            if proc.returncode is None:
                if proc.stdin is not None:
                    proc.stdin.close()
                try:
                    await asyncio.wait_for(proc.wait(), 30)
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()

    try:
        loop.run_until_complete(asyncio.wait_for(start(), limit))
        spans.rows.clear()
        ctx.setup_done()
        with trace.window(spans, ctx.trace, ctx.cuda) as win:
            go = time.monotonic()
            batches0, served0 = dispatcher.batches, dispatcher.served
            reports = loop.run_until_complete(asyncio.wait_for(run_window(), limit))
            batches, served = dispatcher.batches - batches0, dispatcher.served - served0
    finally:
        loop.run_until_complete(stop())
        loop.close()
    rows = [row for report in reports for row in report["conns"]]
    done = sum(r["done"] for r in rows)
    ctx.win, ctx.window_s = win, max(r["last"] for r in rows) - go
    ctx.attempted, ctx.failed = sum(r["sent"] for r in rows), sum(r["sent"] - r["done"] for r in rows)
    ctx.e2e = {"serve_qps": done / ctx.window_s}
    ctx.counters.update(served=served, batches=batches)
    answers = [a for report in reports for a in report["real"]]
    conns_order = [c for p in range(procs_n) for c in range(p, conns, procs_n)]
    ctx.values = []
    for c, answer in zip(conns_order, answers):
        key = ctx.key_list[real_keys[c]]
        try:
            ctx.values.append((real_keys[c], client.process_response(key, base64.b64decode(answer))))
        except Exception:  # an answer the client cannot decode is a wrong value
            ctx.values.append((real_keys[c], None))
    bases = {}
    ctx.kept = []
    for r in rows:
        for conn, counter, answer in r["kept"]:
            if conn not in bases:
                bases[conn] = loadgen.base_query(ctx.seed, conn, m)
            ctx.kept.append((loadgen.query_of(bases[conn], conn, counter), wire_row(base64.b64decode(answer))))
    ctx.kept += [(wire_row(reals[c]), wire_row(base64.b64decode(a))) for c, a in zip(conns_order, answers)]


DRIVERS = {"lookup": lookup, "tcp": tcp, "batch": batch}
