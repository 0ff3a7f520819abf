#!/usr/bin/env python3
"""Benchmark of chalametpir_tpu_torch on one NVIDIA GPU, one cell per run.

    python3 bench_torch.py --cell ctr-2p20-a3 --seed 1
    python3 bench_torch.py --cell ctr-2p20-a3 --seed 1 --device cpu --log-n 10

bench.py's measurements, made through the port. A cell is one fixed
deployment under one traffic mix; CELLS holds them, the choices of
--cell. A run builds the cell's DB from
--seed (random 32-byte keys and random values: the bytes bench.build_db
makes from the same generator), warms up on a small DB, drives the cell's
traffic through the entry points a user calls (Server.setup,
Client.setup, query, query_inline, query_batch, respond, respond_batch,
process_response, save and Server.load, or PirTcpServer), and then checks
every answer against a plain host reference that does not use the code
under test:

- every retrieved value equals db[key];
- the responses at SAMPLED_COLS columns j drawn from the seed equal
  sum_i q_i * D[i, j] mod 2^32, computed in uint64 numpy from D as the
  host encode makes it (core/encode_db.py `from_kv_database`, given a
  generator made from the seed that Server.setup was given), once its
  filter is shown to serialise to the filter params that setup returned;
- SAMPLED_HINT hint entries equal sum_k A[i, k] * D[k, j] mod 2^32, with
  A's rows from the host PRG (core/prg.py);
- each kept query's single respond equals its row of one respond_batch.

A wrong answer makes `correct` false and the exit code 1. No timed window
holds the DB build or a check.

Times: setup and request latency by the host clock around the call, to a
synchronised end; kernels by CUDA events (diag/scan_qd.py `cuda_ms`) at
the cell's own shapes, beside the least time the card could take for the
same work (diag/respond_regimes.py `bound_ms` at the H100's published
peaks; `keccak_bound_ms` for the ctr Keccak kernel); the device's idle
share, its time by kernel and its longest idle gaps from torch.profiler
over one steady closed-loop respond window, each gap labelled by the
record_function span of this script's ("bench.query", "bench.respond",
"bench.process_response") that the host was in; the query upload of
server.respond and of server.respond_batch from the same trace, as the
device time of the host-to-device copies inside their spans (a profiled
window of batches in "bench.respond_batch" spans).

Every stdout line is one self-contained JSON record of at most MAX_LINE
bytes, and each supersedes the one before. The first names the card
(nvidia-smi's name and power limit, and torch.cuda.get_device_name(0));
the last holds every metric of the cell by name as [value, unit], and
`correct`. Device metrics read null on the CPU. The full record
(setup_stats, every sample, the kernel rows, the profiler breakdown, the
checks) goes to chiprun_out/bench_torch/; progress goes to stderr.

The run is on the card unless --device cpu is given (the tests). Without
a CUDA device and without --device cpu it exits 2 before any phase, and
--log-n (the tests' small DB) is refused on the card. Exit 0 only when
every check passed. Imports torch, numpy and the port, never jax or
chalametpir_tpu.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FULL_DIR = os.path.join(ROOT, "chiprun_out", "bench_torch")
MAX_LINE = 1800  # bytes of one stdout record
REFERENCE = ("itzmeanjan/ChalametPIR v0.7.0 README.md:54-70 and integrations/benches/"
             "{offline,online}_phase.rs: 2^20 x 32 B keys x 1 kB values, arity 3 (BASELINE.md)")
WARM = 8  # untimed calls before each closed loop
POOL = 16  # prepared queries (bench.py _client_phases)
POOLED_TIMED, INLINE_TIMED, PROCESS_TIMED = 8, 32, 32
BATCH = 64  # distinct queries per respond_batch
# batch sizes at which a streaming client's s . A is timed (one launch of
# the fused kernel up to kernels.SA_MAX_Q secrets, a launch per SA_MAX_Q
# past it), the rows named SWEEP_ROWS + "{q}"
STREAM_SWEEP_Q = (1, 2, 4, 8, 16, 32, 64)
SWEEP_ROWS = "client_stream_q"
QUERY_THREADS = 8  # threads making a batch's queries, as that many clients would at once
PROFILE_ROUNDS = 20  # closed-loop rounds in the profiled respond window
PROFILE_BATCHES = 4  # respond_batch calls in the profiled batch window
RESTARTS = 5  # timed Server.load calls of one archive
TAIL_BEYOND = 10  # samples beyond the reported tail percentile
SAMPLED_COLS, SAMPLED_HINT, KEPT = 8, 16, 4
TCP_CONNS, TCP_PER_CONN, TCP_MAX_BATCH = 16, 16, 16  # bench.py _run_serve_qps
TCP_TIMEOUT_S = 300.0  # the limit of each phase over the sockets: a stalled answer fails the run
SPANS = ("bench.query", "bench.respond", "bench.process_response", "bench.respond_batch", "bench.serve")
HTOD = "Memcpy HtoD"  # the prefix of the profiler's host-to-device copies


@dataclasses.dataclass(frozen=True)
class Cell:
    """One deployment under one traffic mix. Widths and traffic are fixed;
    only --log-n shrinks the DB, for the CPU tests."""

    name: str
    log_n: int
    why: str
    prg_mode: str = "ctr"
    arity: int = 3
    value_len: int = 1024
    traffic: str = "serve"  # "serve", "tcp" (PirTcpServer) or "lo" (synthetic lo plane)
    responds: int = 100  # closed-loop server.respond calls, after WARM
    batches: int = 0  # closed-loop respond_batch calls of BATCH distinct queries, after one
    restart: bool = False  # save, then RESTARTS timed Server.load calls
    client_engine: str = "resident"  # "resident", "streaming" or "host" (Client.setup(device=False))
    b: int | None = None  # element width; None derives it from the entry count
    source: str = REFERENCE


def by_name(*cells: Cell) -> dict[str, Cell]:
    return {cell.name: cell for cell in cells}


# the registered cells, the only choices of --cell
CELLS = by_name(
    Cell("ctr-2p20-a3", 20,
         "the reference's headline DB in the device PRG mode: K3, the ctr fold, both K1 regimes "
         "(scan at Q = 1, tensor cores at Q = 64), save and restart; one client at a time or "
         "batches of 64 from a front end", responds=200, batches=20, restart=True),
    Cell("stream-2p20-a3", 20,
         "the same DB in the reference's stream PRG mode, which Rust peers speak: the serial host "
         "XOF and A's copies for server and client, the stream fold (K1 at Q = 16)", prg_mode="stream"),
    Cell("stream-2p20-a3-host", 20,
         "stream-2p20-a3's DB and traffic with bench.py's interop client, Client.setup(device=False): A (8.37 GB) "
         "in host memory, s.A in the native ternary matvec on one core; the server on the card (stream fold, K1 "
         "scan); the client launches nothing",
         prg_mode="stream", client_engine="host",
         source="bench.py:1431-1442 run_stage(20, 3, \"stream\", client_device=False): the 2^20 stream row, its host "
                "client the Rust/WASM interop peer (:1366-1368); 2^20 x 32 B x 1 kB, arity 3"),
    Cell("ctr-2p21-a3-streaming", 21,
         "the client's A (16.7 GB) over RESIDENT_PLANES_MAX_BYTES: query() regenerates A per batch in the "
         "fused s.A kernel; K1 over twice the headline rows; an operator past the client's budget",
         client_engine="streaming",
         source="bench.py:782 _run_scaling_point: 2^21 x 32 B keys x 1 kB values, arity 3, ctr, b derived"),
    Cell("ctr-2p20-a3-tcp", 20,
         "the headline DB behind PirTcpServer, as users reach it: 16 connections of closed-loop queries, "
         "the dispatcher's coalesced batches (Q <= 16), framing", traffic="tcp",
         source="bench.py:951 _run_serve_qps's connection shape (16 connections, max_batch 16; its DB is 2^16) "
                "on the 2^20 x 32 B x 1 kB arity-3 headline DB (README.md:54-70), 16 queries a connection"),
    Cell("lo-2p23-b8", 23,
         "2^23 x 1 kB geometry, b = 8: one 10.9 GB lo plane, K2 served at Q = 1 and 64; the plane made "
         "on the card from the seed; the largest plane one card serves",
         traffic="lo", b=8, batches=20,
         source="bench.py:851 _run_scaling_synthetic: the serving geometry of 2^23 x 32 B keys x 1 kB "
                "values, arity 3, at b = 8: a lo plane alone"),
    Cell("ctr-2p16-a4", 16, "a small DB at arity 4: the host work around a ~0.1 ms kernel sets the pace", arity=4,
         responds=200, batches=20, restart=True,
         source="itzmeanjan/ChalametPIR v0.7.0 divan bench, bench-results/*.png (BASELINE.md:30-48): "
                "2^16 x 32 B keys x 1 kB values, arity 4"),
    Cell("ctr-2p20-a4", 20,
         "the headline DB at arity 4: the 4-wise filter and encode at full size, m 4 % under arity 3's; the "
         "client's A (8.02 GB) 7 % under RESIDENT_PLANES_MAX_BYTES, so resident; the ctr-2p20-a3 traffic",
         arity=4, responds=200, batches=20, restart=True,
         source="bench.py:1279-1297 run_stage(20, 4, \"ctr\"): the 2^20 arity-4 row; the reference's 2^20 "
                "arity-4 bench (BASELINE.md:30-48): 2^20 x 32 B keys x 1 kB values, arity 4, ctr"),
    Cell("ctr-2p22-a3-streaming", 22,
         "bench.py's default scaling point: the client's A (33.5 GB, its words past 2^32) regenerated per batch "
         "in the fused s.A kernel; a 4.83 GB lo plane past 2^32 bytes beside its hi plane; an 18.9 MB query; "
         "an operator with 4 M records",
         client_engine="streaming",
         source="bench.py:1384,1412 _run_scaling_point(22): 2^22 x 32 B keys x 1 kB values, arity 3, ctr, "
                "b derived"),
    Cell("ctr-2p23-a3-streaming", 23,
         "the reference's largest DB as a real chain: an 8.39 M-key encode, b = 8, so the ctr setup folds 72 "
         "chunks of a 10.87 GB lo plane (no hi plane) with K2 at Q = 1774 and respond is K2 at Q = 1; the "
         "client's A (66.97 GB) regenerated per batch in the fused s.A kernel; a 37.7 MB query; an operator with "
         "8 M records",
         client_engine="streaming",
         source="bench.py:782 _run_scaling_point(23) (PIR_BENCH_SCALING_LOG_N=23, :1384-1385); BASELINE.json "
                "configs[4]; 2^23 x 32 B x 1 kB, arity 3, ctr, b derived"),
)

# Keccak-p[1600,12] in 32-bit integer operations, counted from the round of
# csrc/ctr_keccak.cu with each 3-input logic function one LOP3 per 32-bit
# half: theta 20 (column parities) + 10 (5 rotations by 1, two funnel
# shifts each) + 50 (folding both into the 25 lanes), rho-pi 48 (24
# rotations), chi 50, iota 2; 12 rounds
KECCAK_OPS = 12 * (20 + 10 + 50 + 48 + 50 + 2)
INT32_LANES_PER_SM = 64  # Hopper's SM (NVIDIA's H100 white paper)


def log(msg: str) -> None:
    print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def int32_ops_per_s() -> float:
    """The card's int32 rate: SMs x 64 lanes x its maximum SM clock, read
    from nvidia-smi."""
    import torch

    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * INT32_LANES_PER_SM * mhz * 1e6


def keccak_bound_ms(nblocks: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of nblocks ctr blocks: the
    168-byte outputs written once at the card's memory rate, or KECCAK_OPS
    per block at the card's int32 rate."""
    from chalametpir_tpu_torch.diag.respond_regimes import CARD_BYTES_PER_S

    by_bytes = nblocks * 168 / CARD_BYTES_PER_S * 1e3
    by_ops = nblocks * KECCAK_OPS / int32_ops_per_s() * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sa_bound_ms(q: int, ncols: int) -> tuple[float, str]:
    """(least ms, "operations") of q secrets' s . A over ncols fingerprint
    columns of ctr A generated on the fly (the fused kernel): KECCAK_OPS
    for each ctr block that holds those columns, once a launch (a launch
    per kernels.SA_MAX_Q secrets), and one multiply-add a word and
    secret, at the card's int32 rate. Nothing of A is stored, so no byte
    bound comes near."""
    from chalametpir_tpu_torch.kernels import SA_MAX_Q
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    words = ncols * LWE_DIMENSION
    ops = -(-q // SA_MAX_Q) * -(-words * 4 // 168) * KECCAK_OPS + q * words
    return ops / int32_ops_per_s() * 1e3, "operations"


def build_db(n: int, value_len: int, rng: np.random.Generator) -> dict[bytes, bytes]:
    """n random 32-byte keys -> random value_len-byte values: the bytes
    bench.build_db makes from the same generator (values first, in 64 MB
    draws, then the keys)."""
    from chalametpir_tpu_torch.native.engine import alloc_array

    vals = alloc_array((n * value_len,), np.uint8)
    step = 64 << 20
    for i in range(0, vals.size, step):
        chunk = min(step, vals.size - i)
        vals[i : i + chunk] = np.frombuffer(rng.bytes(chunk), np.uint8)
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    # void views, not S: S-dtype tolist() strips trailing NUL bytes
    values = vals.view(f"V{value_len}").tolist()
    db = dict(zip(keys.view("V32").ravel().tolist(), values))
    while len(db) < n:  # 32-byte key collisions are vanishingly unlikely
        db[rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()] = values[0]
    return db


def tail(samples: list[float]) -> tuple[int, float]:
    """(p, value): the highest whole percentile with at least TAIL_BEYOND
    samples above its value (p95 of 200 samples, p90 of 100)."""
    n = len(samples)
    p = 100 * (n - TAIL_BEYOND) // n
    return p, sorted(samples)[-(-p * n // 100) - 1]


def median_ms(seconds: list[float]) -> float:
    return statistics.median(seconds) * 1e3


PIR_SEED, SETUP, TRAFFIC = 0, 1, 2  # the run's generators besides the DB's


def stream_of(seed: int, which: int) -> np.random.Generator:
    """A generator of its own from --seed: the PIR seed's, the one
    Server.setup is given (made again for the check), or the traffic's
    (keys, queries, sampled columns). The DB's is
    np.random.default_rng(seed), as bench.build_db is given one."""
    return np.random.default_rng((seed, which))


# -- records ------------------------------------------------------------------


class Record:
    """The run's records: each emit() prints one compact line (every metric
    so far, at most MAX_LINE bytes) and rewrites the full record."""

    def __init__(self, cell: Cell, seed: int, card: str, full_path: str | None):
        self.head = {"cell": cell.name, "seed": seed, "card": card}
        self.metrics: dict[str, list] = {}  # end to end
        self.layers: dict[str, list] = {}  # per layer
        self.launches: dict[str, int] | None = None
        self.correct: bool | None = None
        self.full: dict = {"cell": dataclasses.asdict(cell), "walls_s": {}}
        self.full_path = full_path
        self.t0 = time.perf_counter()

    def metric(self, name: str, value, unit: str) -> None:
        self.metrics[name] = [value, unit]

    def layer(self, name: str, value, unit: str) -> None:
        self.layers[name] = [value, unit]

    def line(self, phase: str) -> str:
        def short(v):
            return float(f"{v:.6g}") if isinstance(v, float) else v

        obj = {**self.head, "phase": phase, "correct": self.correct,
               "metrics": {k: [short(v), u] for k, (v, u) in self.metrics.items()},
               "layers": {k: [short(v), u] for k, (v, u) in self.layers.items()}}
        if self.launches is not None:
            obj["launches"] = self.launches
        if self.full_path:
            obj["full"] = os.path.relpath(self.full_path, ROOT)
        line = json.dumps(obj, separators=(",", ":"))
        if len(line.encode()) > MAX_LINE:
            raise AssertionError(f"a record of {len(line.encode())} bytes passes MAX_LINE")
        return line

    def emit(self, phase: str) -> None:
        """Print the compact line; rewrite the full record, with the run's
        wall time at the end of `phase`."""
        self.full["walls_s"][phase] = time.perf_counter() - self.t0
        print(self.line(phase), flush=True)
        if self.full_path:
            full = {**self.head, "phase": phase, "correct": self.correct, "metrics": self.metrics,
                    "layers": self.layers, "launches": self.launches, **self.full}
            os.makedirs(os.path.dirname(self.full_path), exist_ok=True)
            with open(self.full_path + ".tmp", "w") as f:
                json.dump(full, f, indent=1, default=str)
            os.replace(self.full_path + ".tmp", self.full_path)


def card_use(dev) -> tuple[int, int]:
    """(kernel launches, allocations on the card) so far: the port's launch
    counts and torch's count of allocation requests on `dev`."""
    import torch

    from chalametpir_tpu_torch import kernels

    return sum(kernels.LAUNCHES.values()), torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)


class Checks:
    """Counts of answers checked and answers wrong, per kind of check, of
    queries made again after the protocol's indicator overflow, and of what
    a host client did on the card (it must do nothing there)."""

    KINDS = ("retrievals", "columns", "hint", "batch_vs_single")

    def __init__(self):
        self.counts = {kind: [0, 0] for kind in self.KINDS}  # [checked, wrong]
        self.query_retries = 0
        self.host_card_use = {"launches": 0, "allocations": 0}

    def count(self, kind: str, ok: bool) -> None:
        self.counts[kind][0] += 1
        self.counts[kind][1] += not ok

    @contextlib.contextmanager
    def card_use_of(self, host: bool, dev):
        """Around a client's work: for a host client (`host`) on a card, the
        kernels launched and the card allocations made inside the block are
        added to host_card_use; for a device client, or on the CPU, nothing."""
        if not host or dev.type != "cuda":
            yield
            return
        before = card_use(dev)
        try:
            yield
        finally:
            for name, b0, b1 in zip(self.host_card_use, before, card_use(dev)):
                self.host_card_use[name] += b1 - b0

    def correct(self, kinds) -> bool:
        """Every check of `kinds` made at least once, none wrong, and no
        card use by a host client."""
        return (all(self.counts[k][0] > 0 and self.counts[k][1] == 0 for k in kinds)
                and not any(self.host_card_use.values()))


# -- the protocol through the port --------------------------------------------


def query(client, key: bytes, checks: Checks, fn=None) -> bytes:
    """client.query (or `fn`), retried on the protocol's rare indicator
    overflow; each retry is counted in `checks` (a streaming client pays a
    whole s.A batch for it)."""
    from chalametpir_tpu_torch import ArithmeticOverflowAddingQueryIndicator

    while True:
        try:
            return (fn or client.query)(key)
        except ArithmeticOverflowAddingQueryIndicator:
            checks.query_retries += 1


def retrieve(client, key: bytes, response: bytes, db, checks: Checks) -> None:
    """process_response, its value held against db[key]; a response the
    client cannot decode is a wrong answer."""
    from chalametpir_tpu_torch.errors import DecodedRowNotPrependedWithDigestOfKey, RowNotDecodable

    try:
        value = client.process_response(key, response)
    except (RowNotDecodable, DecodedRowNotPrependedWithDigestOfKey):
        value = None
    checks.count("retrievals", value == db[key])


def row_bytes(row: np.ndarray) -> bytes:
    """One (C,) uint32 row as a wire matrix."""
    from chalametpir_tpu_torch.core import matrix_io

    return matrix_io.matrix_to_bytes(np.ascontiguousarray(row, np.uint32)[None, :])


def wire_row(data: bytes) -> np.ndarray:
    """The one row of a wire matrix (a query or a response) as uint32."""
    from chalametpir_tpu_torch.core import matrix_io

    return matrix_io.matrix_from_bytes(data)[0]


def synchronize(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev):
    """(fn(), host seconds to a synchronised end)."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def warm_up(prg_mode: str, arity: int, n: int, dev, checks: Checks) -> None:
    """An n-entry round trip in the cell's PRG mode and arity before any
    timed window: the card's context, the kernels' modules, the native
    engine and torch's allocator are ready before the first timed call."""
    from chalametpir_tpu_torch import Client, Server

    db = build_db(n, 1024, np.random.default_rng(0))
    seed = bytes(32)
    server, hint, fparams = Server.setup(seed, db, arity=arity, prg_mode=prg_mode, rng=np.random.default_rng(0),
                                         device=dev)
    client = Client.setup(seed, hint, fparams, prg_mode=prg_mode, device=dev)
    keys = list(db)[:BATCH]
    for key in keys[:4]:
        retrieve(client, key, server.respond(query(client, key, checks)), db, checks)
    qmat = np.stack([wire_row(qb) for qb in client.query_batch(keys[4:])])
    for key, row in zip(keys[4:], server.respond_batch(qmat)):
        retrieve(client, key, row_bytes(row), db, checks)
    synchronize(dev)


def make_queries(client, keys: list[bytes], makers: concurrent.futures.Executor) -> list[bytes]:
    """client.query_batch over `keys`, in order, in QUERY_THREADS parts made
    at once: the queries of one batch come from many clients, and their
    host work, not the server's, would otherwise be most of this run."""
    step = -(-len(keys) // QUERY_THREADS)
    parts = makers.map(client.query_batch, [keys[i : i + step] for i in range(0, len(keys), step)])
    return [qb for part in parts for qb in part]


def closed_loop(client, server, keys, db, checks: Checks, kept: list | None = None) -> tuple[list[float], float]:
    """One client, one request in flight: query, server.respond (timed by
    the host clock), process_response, each in its span. Returns the
    respond times after WARM and the mean round trip over those rounds
    (their whole wall time, query to process_response and what lies
    between rounds, over their count); appends the (query, response) rows
    of the first timed keys to `kept` until it holds KEPT."""
    from torch.profiler import record_function

    times = []
    t0_rounds = time.perf_counter()
    for i, key in enumerate(keys):
        if i == WARM:
            t0_rounds = time.perf_counter()
        with record_function("bench.query"), checks.card_use_of(not client.uses_device, server.device):
            qb = query(client, key, checks)
        with record_function("bench.respond"):
            t0 = time.perf_counter()
            rb = server.respond(qb)
            dt = time.perf_counter() - t0
        with record_function("bench.process_response"), checks.card_use_of(not client.uses_device, server.device):
            retrieve(client, key, rb, db, checks)
        if i >= WARM:
            times.append(dt)
            if kept is not None and len(kept) < KEPT:
                kept.append((wire_row(qb), wire_row(rb)))
    return times, (time.perf_counter() - t0_rounds) / max(1, len(times))


def profile_window(rounds_fn, dev) -> dict:
    """Run rounds_fn() under torch.profiler (CPU and, on the card, CUDA
    activity) and read the device's time inside the window spanned by this
    script's spans: the kernels and copies that took the most of it,
    `idle_breakdown` of the rest, and the median device ms of the
    host-to-device copies each kind of span starts (`htod_ms_by_span`).
    Without device activity (the CPU, or a profiler that recorded none)
    the device numbers are None and `htod_ms_by_span` is empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        rounds_fn()
        synchronize(dev)
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name in SPANS)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    out = {"window_ms": (spans[-1][1] - spans[0][0]) / 1e3 if spans else None, "top_device_ops": [],
           "device_idle_share": None, "respond_idle_share": None, "htod_ms_by_span": {}}
    if not spans or not device:
        return out
    copies = [(e.time_range.start, e.time_range.end) for e in device if e.name.startswith(HTOD)]
    out["htod_ms_by_span"] = {name: statistics.median(per) for name, per in copy_ms_by_span(spans, copies).items()}
    by_name: dict[str, list] = {}
    for e in device:
        total = by_name.setdefault(e.name, [0.0, 0])
        total[0] += (e.time_range.end - e.time_range.start) / 1e3
        total[1] += 1
    out["top_device_ops"] = [{"name": name[:80], "ms": ms, "count": n}
                             for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]]
    out.update(idle_breakdown(spans, [(e.time_range.start, e.time_range.end) for e in device]))
    return out


def copy_ms_by_span(spans: list[tuple[float, float, str]], copies: list[tuple[float, float]]) -> dict[str, list]:
    """{span name: [device ms of the copies it launched, one sum per
    instance of the span]} (spans: the host's (start, end, name), not
    overlapping; copies: the device's (start, end); microseconds). A copy
    is the span's that it overlaps most, even where it ends after the
    span: the trace aligns the device's clock to the host's only to some
    microseconds, so a copy launched as its span begins can read as
    starting before it. A copy that overlaps no span is in none."""
    sums = [0.0] * len(spans)
    for c0, c1 in copies:
        overlaps = [min(c1, s1) - max(c0, s0) for s0, s1, _ in spans]
        best = max(range(len(spans)), key=overlaps.__getitem__, default=None)
        if best is not None and overlaps[best] > 0:
            sums[best] += c1 - c0
    out: dict[str, list] = {}
    for (_, _, name), total in zip(spans, sums):
        out.setdefault(name, []).append(total / 1e3)
    return out


def profile_batches(server, qmats: list, dev) -> tuple[dict, list]:
    """profile_window over server.respond_batch of each of `qmats`, each in
    its span; returns the profile and the responses."""
    from torch.profiler import record_function

    resps = []

    def batches():
        for qmat in qmats:
            with record_function("bench.respond_batch"):
                resps.append(server.respond_batch(qmat))

    return profile_window(batches, dev), resps


def idle_breakdown(spans: list[tuple[float, float, str]], busy: list[tuple[float, float]]) -> dict:
    """The device's idle time in the window from the first span's start to
    the last one's end (spans: the host's (start, end, name), in order and
    not nested; busy: the device's (start, end) intervals; microseconds):
    its share of the window, the ms of it inside each span and between
    them, the share of bench.respond's time it takes, and the longest
    gaps, each labelled by the span that holds most of it."""
    w0, w1 = spans[0][0], spans[-1][1]
    merged: list[list[float]] = []
    for start, end in sorted((max(b0, w0), min(b1, w1)) for b0, b1 in busy):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    edges = [w0] + [x for interval in merged for x in interval] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    span_ms: dict[str, float] = {}
    for s0, s1, name in spans:
        span_ms[name] = span_ms.get(name, 0.0) + (s1 - s0) / 1e3
    idle: dict[str, float] = {}
    longest = []
    for g0, g1 in gaps:
        parts = {"between spans": (g1 - g0) / 1e3}
        for s0, s1, name in spans:
            inside = (min(g1, s1) - max(g0, s0)) / 1e3
            if inside > 0:
                parts[name] = parts.get(name, 0.0) + inside
                parts["between spans"] -= inside
        for name, ms in parts.items():
            idle[name] = idle.get(name, 0.0) + ms
        longest.append({"ms": (g1 - g0) / 1e3, "span": max(parts, key=parts.get)})
    return {
        "device_idle_share": sum(g1 - g0 for g0, g1 in gaps) / (w1 - w0),
        "respond_idle_share": (idle.get("bench.respond", 0.0) / span_ms["bench.respond"]
                               if "bench.respond" in span_ms else None),
        "ms_by_span": span_ms,
        "idle_ms_by_span": idle,
        "longest_idle_gaps": sorted(longest, key=lambda g: -g["ms"])[:8],
    }


# -- the plain reference --------------------------------------------------------


def host_d_columns(db, arity: int, b: int, setup_seed_rng: np.random.Generator, fparams: bytes,
                   cols: np.ndarray) -> np.ndarray | None:
    """D[:, cols] (m, len(cols)) uint16 from the host encode, or None when
    its filter does not serialise to `fparams`: the encode
    (core/encode_db.py from_kv_database) with a generator of the seed
    Server.setup was given."""
    from chalametpir_tpu_torch.core import encode_db

    mat_d, filt = encode_db.from_kv_database(db, arity, b, rng=setup_seed_rng)
    if filt.to_bytes() != fparams:
        return None
    return np.ascontiguousarray(mat_d[:, cols])


def host_a_rows(seed: bytes, m: int, rows: np.ndarray, mode: str) -> np.ndarray:
    """A[rows] as (len(rows), m) uint32 from the host PRG (core/prg.py). In
    stream mode the serial XOF is read up to the last row asked for; ctr A
    is fingerprint-major, so every row needs the whole stream, expanded
    in column chunks on every core."""
    from chalametpir_tpu_torch.core import prg
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    out = np.empty((len(rows), m), np.uint32)
    if mode == "stream":
        where = {int(r): i for i, r in enumerate(rows)}
        for r0, block in prg.iter_row_blocks(LWE_DIMENSION, m, seed, 16, mode="stream"):
            for r in range(r0, r0 + block.shape[0]):
                if r in where:
                    out[where[r]] = block[r - r0]
            if r0 + block.shape[0] > max(where):
                return out
        return out
    step = 1 << 14

    def chunk(c0: int) -> tuple[int, np.ndarray]:
        return c0, prg.expand_fp_block(LWE_DIMENSION, c0, min(step, m - c0), seed)[:, rows].T

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        for c0, part in pool.map(chunk, range(0, m, step)):
            out[:, c0 : c0 + part.shape[1]] = part
    return out


def column_product(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """left . right mod 2^32 in uint64 numpy (wrapping mod 2^64, a multiple
    of 2^32)."""
    return (left.astype(np.uint64) @ right.astype(np.uint64)).astype(np.uint32)


def check_columns(kept, d_cols, cols, checks: Checks) -> None:
    """The kept responses at `cols` against q . D[:, cols] on the host."""
    if d_cols is None:
        checks.count("columns", False)
        return
    want = column_product(np.stack([q for q, _ in kept]), d_cols)
    for (_, resp), row in zip(kept, want):
        checks.count("columns", np.array_equal(resp[cols], row))


def check_hint(hint: np.ndarray, seed: bytes, d_cols, cols, mode: str, rng, checks: Checks) -> dict:
    """SAMPLED_HINT entries of the hint against A[i] . D[:, j] on the host."""
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    if d_cols is None:
        checks.count("hint", False)
        return {}
    rows = rng.choice(LWE_DIMENSION, size=SAMPLED_HINT, replace=False)
    which = rng.integers(0, len(cols), size=SAMPLED_HINT)
    t0 = time.perf_counter()
    a = host_a_rows(seed, d_cols.shape[0], rows, mode)
    for k, (i, j) in enumerate(zip(rows, which)):
        want = column_product(a[k][None, :], d_cols[:, j : j + 1])[0, 0]
        checks.count("hint", hint[i, cols[j]] == want)
    return {"rows": rows.tolist(), "a_rows_s": time.perf_counter() - t0}


def check_batch_vs_single(server, kept, checks: Checks) -> None:
    """Each kept query's single respond and its row of one respond_batch of
    them all, from `server` (the traffic's, or one loaded from its
    archive), equal the response kept from the traffic."""
    batch = server.respond_batch(np.stack([q for q, _ in kept]))
    for (q, resp), row in zip(kept, batch):
        single = wire_row(server.respond(row_bytes(q)))
        checks.count("batch_vs_single", np.array_equal(single, resp) and np.array_equal(row, resp))


def check_on_the_host(cell: Cell, seed: int, db, b: int, num_cols: int, fparams: bytes, hint: bytes,
                      pir_seed: bytes, kept, rng: np.random.Generator, checks: Checks, rec: Record) -> None:
    """The checks that need nothing of the device, made once the traffic is
    done and the server gone: the kept responses at SAMPLED_COLS columns
    drawn by `rng` and SAMPLED_HINT hint entries against the host
    reference; then `correct`."""
    from chalametpir_tpu_torch.core import matrix_io

    cols = np.sort(rng.choice(num_cols, size=SAMPLED_COLS, replace=False))
    t0 = time.perf_counter()
    d_cols = host_d_columns(db, cell.arity, b, stream_of(seed, SETUP), fparams, cols)
    check_columns(kept, d_cols, cols, checks)
    rec.full["hint_check"] = check_hint(matrix_io.matrix_from_bytes(hint), pir_seed, d_cols, cols, cell.prg_mode,
                                        rng, checks)
    rec.full["check_s"] = time.perf_counter() - t0
    rec.correct = checks.correct(Checks.KINDS)


# -- the kernels at the cell's shapes --------------------------------------------


def kernel_rows(cell: Cell, server, pir_seed: bytes, rng: np.random.Generator, client=None) -> dict:
    """CUDA-event medians of each kernel of the cell's path at its own
    shapes, each beside its bound, that bound's share of its time, the
    kernels one call launches, its plain version's time on the same
    inputs and, for a batch of BATCH queries and for each hint fold
    (LIBRARY_ROWS), the library call's: torch._int_mm(qd, lo) of the
    queries' (or A rows') int8 digit rows, 4 a row, and the lo plane they
    are folded over (diag/scan_qd.py `int_mm_ms`; over a hi plane too it
    is the lo product alone); for a streaming client also one s.A batch
    of its engine at Q = 1 and at each of STREAM_SWEEP_Q (the fused
    kernel), bounded by its Keccak and dot work. A host client launches
    nothing and has no row. On the CPU the same rows, built and named,
    with None for each (no device time is measured there)."""
    import torch

    from chalametpir_tpu_torch import kernels
    from chalametpir_tpu_torch.diag.respond_regimes import bound_ms
    from chalametpir_tpu_torch.diag.scan_qd import cuda_ms, int_mm_ms
    from chalametpir_tpu_torch.models.server import STREAM_BLOCK_ROWS, _ctr_chunk_cols
    from chalametpir_tpu_torch.ops import prg_torch
    from chalametpir_tpu_torch.ops.digits import prepare_query_digits
    from chalametpir_tpu_torch.ops.respond_packed import (
        M_ALIGN, hint_fold_partial, pack_geometry, respond_batch_packed, respond_packed_core, respond_packed_ref)
    from chalametpir_tpu_torch.params import LWE_DIMENSION

    planes = server.planes
    dev, b, m, c = planes.device, planes.mat_elem_bit_len, planes.num_rows, planes.num_cols
    c_pad = planes.lo.shape[1]
    pack = pack_geometry(b, c_pad)[0]
    rows = {}

    def row(name: str, fn, reps: int, bound, plain=None, library=None) -> None:
        """Time fn after one call whose launches are counted, and `plain`,
        its plain version, where given; `bound` gives (least ms, what
        bounds it); `library` the library call's ms, where there is one."""
        if dev.type != "cuda":
            rows[name] = None
            return
        before = dict(kernels.LAUNCHES)
        fn()
        torch.cuda.synchronize(dev)
        launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
        ms, (least, by) = cuda_ms(fn, reps, warmup=0), bound()
        plain_ms = cuda_ms(plain, 2) if plain else None
        library_ms = library() if library else None
        rows[name] = {"ms": ms, "bound_ms": least, "bound_by": by, "of_bound": least / ms, "launches": launched,
                      "plain_ms": plain_ms, "library_ms": library_ms}
        log(f"{name}: {ms:.4f} ms, bound {least:.4f} ms ({by}; {least / ms:.1%}), launches {launched}, "
            f"plain {plain_ms} ms, library {library_ms} ms")

    def random_u32(q: int, n: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 1 << 32, size=(q, n), dtype=np.uint32).view(np.int32)).to(dev)

    def int_mm(queries: torch.Tensor, lo: torch.Tensor):
        """The library call's timer over these queries' digit rows and `lo`."""
        if dev.type != "cuda":
            return None
        qd = prepare_query_digits(queries, lo.shape[0])[0]
        return lambda: int_mm_ms(qd, lo)

    k = "k1" if pack else "k2"
    for q in (1, BATCH) if cell.batches else (1,):
        queries = random_u32(q, m)
        library = int_mm(queries, planes.lo) if q == BATCH else None
        row(f"{k}_{kernels.choose_regime(q, pack)}_q{q}", lambda: respond_batch_packed(queries, planes), 20,
            lambda: bound_ms(q, m, c_pad, planes.device_bytes, b),
            lambda: respond_packed_ref(queries, planes.lo, planes.hi, b, c), library)
    if cell.traffic == "lo":
        return rows
    if cell.client_engine == "streaming":
        # query()'s batch once the pool is empty: one secret
        engine, codes = client._engine, rng.integers(0, 3, size=(1, LWE_DIMENSION), dtype=np.uint8)
        m_out = -(-m // 8) * 8
        row("client_stream_batch", lambda: engine.matvec_batch_async(codes), 5, lambda: sa_bound_ms(1, m_out))
        # each batch size, where kernels.SA_MAX_Q comes from
        for q in STREAM_SWEEP_Q:
            sweep_codes = rng.integers(0, 3, size=(q, LWE_DIMENSION), dtype=np.uint8)
            row(f"{SWEEP_ROWS}{q}", lambda: engine.matvec_batch_async(sweep_codes), 5, lambda: sa_bound_ms(q, m_out))
    if cell.prg_mode == "stream":
        block = random_u32(STREAM_BLOCK_ROWS, m)
        out = torch.zeros((STREAM_BLOCK_ROWS, c_pad), dtype=torch.int32, device=dev)
        row("stream_fold_block", lambda: respond_packed_core(block, planes.lo, planes.hi, b, c, out=out), 20,
            lambda: bound_ms(STREAM_BLOCK_ROWS, m, c_pad, planes.device_bytes, b),
            lambda: respond_packed_ref(block, planes.lo, planes.hi, b, c), int_mm(block, planes.lo))
        return rows
    # the ctr setup's chunk: its K3 blocks, then its fold
    cc = min(_ctr_chunk_cols(m, M_ALIGN), planes.lo.shape[0])
    words = prg_torch.seed_to_words(pir_seed)
    nblocks = cc * LWE_DIMENSION * 4 // 168 + 2
    row("k3_chunk", lambda: prg_torch.ctr_blocks(words, 0, nblocks, dev), 10, lambda: keccak_bound_ms(nblocks),
        lambda: prg_torch.ctr_blocks_ref(words, 0, nblocks, dev))
    slab = prg_torch.expand_fp_slab(words, 0, cc, LWE_DIMENSION, dev)
    lo_c, hi_c = planes.lo[:cc], planes.hi[:cc] if planes.hi is not None else None
    chunk_bytes = lo_c.numel() + (hi_c.numel() if hi_c is not None else 0)
    row("ctr_fold_chunk", lambda: hint_fold_partial(slab.t(), lo_c, hi_c, b, c), 5,
        lambda: bound_ms(LWE_DIMENSION, cc, c_pad, chunk_bytes, b),
        lambda: respond_packed_ref(slab.t(), lo_c, hi_c, b, c), int_mm(slab.t(), lo_c))
    return rows


# the kernel rows besides the batches' that carry the library call's time
LIBRARY_ROWS = ("ctr_fold_chunk", "stream_fold_block")


def record_kernels(rec: Record, rows: dict) -> None:
    """Every row into the full record; each row but the route sweep's
    (SWEEP_ROWS, too many for the last line) as layers."""
    rec.full["kernels"] = rows
    for name, r in rows.items():
        if name.startswith(SWEEP_ROWS):
            continue
        rec.layer(f"{name}_ms", r and r["ms"], "ms")
        rec.layer(f"{name}_of_bound", r and r["of_bound"], "1")
        if name.endswith(f"_q{BATCH}") or name in LIBRARY_ROWS:
            rec.layer(f"{name}_int_mm_ms", r and r["library_ms"], "ms")


# -- the runners ---------------------------------------------------------------


def setup_stats_fields(stats: dict) -> dict:
    """bench.py `_setup_stats_fields`: the upload floor measured inside the
    setup, the per-thread CPU split and the worker's page faults."""
    out = {}
    if stats.get("upload_bytes"):
        out["server_setup_upload_GB"] = stats["upload_bytes"] / 1e9
        out["server_setup_upload_s"] = stats["upload_s"]
        if stats["upload_s"]:
            out["server_setup_upload_GBps"] = stats["upload_bytes"] / 1e9 / stats["upload_s"]
        if stats.get("phases_s"):
            out["server_setup_phases_s"] = stats["phases_s"]
    if stats.get("cpu_s"):
        out["server_setup_cpu_s"] = stats["cpu_s"]
    if stats.get("worker_minflt") is not None:
        out["server_setup_worker_minflt"] = stats["worker_minflt"]
    return out


def set_up(cell: Cell, n: int, seed: int, dev, rec: Record, checks: Checks):
    """The cell's DB (untimed), then Server.setup and Client.setup, each
    timed by the host clock to a synchronised end. The client is set up on
    `dev`, or with device=False (the host engine) for a "host" cell."""
    from chalametpir_tpu_torch import Client, Server, kernels

    t0 = time.perf_counter()
    db = build_db(n, cell.value_len, np.random.default_rng(seed))
    log(f"{n} entries x {cell.value_len} B built in {time.perf_counter() - t0:.1f} s (untimed)")
    pir_seed = stream_of(seed, PIR_SEED).bytes(32)
    # the dict's millions of objects would be walked by every collection
    # of the setup's allocations; run() unfreezes when the cell is done
    gc.freeze()
    before = dict(kernels.LAUNCHES)
    (server, hint, fparams), setup_s = timed(lambda: Server.setup(
        pir_seed, db, arity=cell.arity, prg_mode=cell.prg_mode, rng=stream_of(seed, SETUP),
        mat_elem_bit_len=cell.b, device=dev), dev)
    rec.metric("server_setup_s", setup_s, "s")
    rec.full["server_setup_stats"] = server.setup_stats
    rec.full["server_setup_launches"] = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    planes = server.planes
    rec.full["geometry"] = {"b": planes.mat_elem_bit_len, "m": planes.num_rows, "c": planes.num_cols,
                            "m_pad": planes.lo.shape[0], "c_pad": planes.lo.shape[1],
                            "plane_bytes": planes.device_bytes, "hi_plane": planes.hi is not None}
    rec.full.update(setup_stats_fields(server.setup_stats))
    rec.layer("setup_phases_s", server.setup_stats.get("phases_s"), "s")
    log(f"server setup {setup_s:.3f} s, b={server.mat_elem_bit_len}, m={server.num_query_cols}, "
        f"c={server.num_response_cols}")
    client_dev = False if cell.client_engine == "host" else dev
    with checks.card_use_of(cell.client_engine == "host", dev):
        client, client_s = timed(lambda: Client.setup(pir_seed, hint, fparams, prg_mode=cell.prg_mode,
                                                      device=client_dev), dev)
    rec.metric("client_setup_s", client_s, "s")
    rec.full["client_setup_stats"] = client.setup_stats
    if client.setup_stats["engine"] != cell.client_engine:
        raise AssertionError(f"the client chose the {client.setup_stats['engine']} engine, the cell is "
                             f"for the {cell.client_engine} one")
    log(f"client setup {client_s:.3f} s ({client.setup_stats['engine']} engine)")
    rec.emit("setup")
    return db, pir_seed, server, hint, fparams, client


def client_phases(client, server, db, keys, rec: Record, checks: Checks) -> None:
    """bench.py `_client_phases`: prepare_queries(POOL); pooled query, warm
    1 and the median of POOLED_TIMED; query_inline, warm 1 and the median
    of INLINE_TIMED; process_response through discard_query /
    insert_query, the median of PROCESS_TIMED. Every query is answered and
    its value checked after its timing."""
    dev = server.device
    with checks.card_use_of(not client.uses_device, dev):
        _, prep_s = timed(lambda: client.prepare_queries(POOL), dev)
    rec.metric("client_prepare_per_query_ms", prep_s / POOL * 1e3, "ms")
    stats = rec.full["client_prepare_stats"] = dict(client.prepare_stats)
    if "host_matvec_s" in stats:  # the host engine's s.A, one secret each
        rec.layer("host_matvec_ms", stats["host_matvec_s"] / stats["count"] * 1e3, "ms")
    pooled, inline = keys[: 1 + POOLED_TIMED], keys[1 + POOLED_TIMED : 2 + POOLED_TIMED + INLINE_TIMED]
    for group, fn, name in ((pooled, client.query, "client_query_ms"),
                            (inline, client.query_inline, "client_query_inline_ms")):
        made, times = [], []
        with checks.card_use_of(not client.uses_device, dev):
            for key in group:
                t0 = time.perf_counter()
                made.append(query(client, key, checks, fn))
                times.append(time.perf_counter() - t0)
        rec.metric(name, median_ms(times[1:]), "ms")
        rec.full[name.replace("_ms", "_samples_s")] = times[1:]
        for key, qb in zip(group, made):
            retrieve(client, key, server.respond(qb), db, checks)
    key = keys[-1]
    rb = server.respond(query(client, key, checks))
    held = client.discard_query(key)
    times = []
    with checks.card_use_of(not client.uses_device, dev):
        for _ in range(PROCESS_TIMED):
            client.insert_query(key, held)
            t0 = time.perf_counter()
            value = client.process_response(key, rb)
            times.append(time.perf_counter() - t0)
            checks.count("retrievals", value == db[key])
    rec.metric("client_process_response_us", statistics.median(times) * 1e6, "us")


def run_serve(cell: Cell, n: int, seed: int, dev, rec: Record, checks: Checks) -> None:
    """The serving traffic: setup, bench.py's client phases, `responds`
    closed-loop server.respond calls, `batches` closed-loop respond_batch
    calls of BATCH distinct queries and a profiled window of
    PROFILE_BATCHES more, save and RESTARTS timed Server.load calls, the
    profiled closed-loop window; then the kernels at the cell's shapes and
    the checks."""
    import torch

    from chalametpir_tpu_torch import Server, kernels

    db, pir_seed, server, hint, fparams, client = set_up(cell, n, seed, dev, rec, checks)
    traffic = stream_of(seed, TRAFFIC)
    keys = list(db)

    def draw(k: int) -> list[bytes]:
        return [keys[i] for i in traffic.choice(n, size=k, replace=False)]

    client_phases(client, server, db, draw(3 + POOLED_TIMED + INLINE_TIMED), rec, checks)
    rec.emit("client")

    kept: list = []
    times, round_trip_s = closed_loop(client, server, draw(WARM + cell.responds), db, checks, kept)
    rec.metric("respond_ms", median_ms(times), "ms")
    p, value = tail(times)
    rec.metric(f"respond_p{p}_ms", value * 1e3, "ms")
    rec.metric("round_trip_ms", round_trip_s * 1e3, "ms")
    rec.full["respond_samples_s"] = times
    log(f"server.respond median {median_ms(times):.3f} ms, p{p} {value * 1e3:.3f} ms over {len(times)}; "
        f"round trip {round_trip_s * 1e3:.3f} ms")
    rec.emit("respond")

    if cell.batches:
        batch_times = []
        with concurrent.futures.ThreadPoolExecutor(QUERY_THREADS) as makers:
            for i in range(1 + cell.batches):  # the first is a warm-up
                batch_keys = draw(BATCH)
                qmat = np.stack([wire_row(qb) for qb in make_queries(client, batch_keys, makers)])
                resp, dt = timed(lambda: server.respond_batch(qmat), dev)
                for key, row in zip(batch_keys, resp):
                    retrieve(client, key, row_bytes(row), db, checks)
                if i:
                    batch_times.append(dt)
                if i == 1:
                    kept += list(zip(qmat[:KEPT], resp[:KEPT]))
            flat = draw(PROFILE_BATCHES * BATCH)  # every query pending at once: distinct keys
            batch_keys = [flat[i : i + BATCH] for i in range(0, len(flat), BATCH)]
            qmats = [np.stack([wire_row(qb) for qb in make_queries(client, k, makers)]) for k in batch_keys]
        rec.metric("respond_batch_qps", cell.batches * BATCH / sum(batch_times), "1/s")
        rec.full["respond_batch_samples_s"] = batch_times
        log(f"respond_batch of {BATCH}: median {median_ms(batch_times):.3f} ms")
        batch_profile, resps = profile_batches(server, qmats, dev)
        for k, resp in zip(batch_keys, resps):
            for key, row in zip(k, resp):
                retrieve(client, key, row_bytes(row), db, checks)
        rec.full["batch_profile"] = batch_profile
        rec.layer(f"upload_q{BATCH}_ms", batch_profile["htod_ms_by_span"].get("bench.respond_batch"), "ms")
        rec.emit("respond_batch")

    if cell.restart:
        loads = []
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "server.npz")
            _, save_s = timed(lambda: server.save(path), dev)
            rec.full["save_s"], rec.full["archive_bytes"] = save_s, os.path.getsize(path)
            for _ in range(RESTARTS):
                loaded, load_s = timed(lambda: Server.load(path, device=dev), dev)
                loads.append(load_s)
                check_batch_vs_single(loaded, kept, checks)  # the traffic's answers, from the loaded planes
                del loaded
                if dev.type == "cuda":  # each load allocates its planes anew, as a restarted process does
                    torch.cuda.empty_cache()
        rec.metric("restart_s", statistics.median(loads), "s")
        rec.full["restart_samples_s"] = loads
        log(f"save {save_s:.3f} s, Server.load median {statistics.median(loads):.3f} s of {RESTARTS}")
        rec.emit("restart")

    profiled = profile_window(lambda: closed_loop(client, server, draw(PROFILE_ROUNDS), db, checks), dev)
    rec.full["profile"] = profiled
    rec.layer("device_idle_share", profiled["device_idle_share"], "1")
    rec.layer("device_idle_share_in_respond", profiled["respond_idle_share"], "1")
    rec.layer("upload_q1_ms", profiled["htod_ms_by_span"].get("bench.respond"), "ms")
    rec.launches = dict(kernels.LAUNCHES)

    record_kernels(rec, kernel_rows(cell, server, pir_seed, traffic, client))
    rec.emit("kernels")

    check_batch_vs_single(server, kept, checks)
    b, num_cols = server.mat_elem_bit_len, server.num_response_cols
    del server, client
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check_on_the_host(cell, seed, db, b, num_cols, fparams, hint, pir_seed, kept, traffic, checks, rec)


def run_tcp(cell: Cell, n: int, seed: int, dev, rec: Record, checks: Checks) -> None:
    """The DB behind the port's PirTcpServer (max_batch TCP_MAX_BATCH):
    TCP_CONNS connections on 127.0.0.1, each sending one warm query, then
    TCP_PER_CONN closed-loop queries (the timed window), then one more in
    a profiled window; the queries made by one client beforehand, every
    response processed after. Each phase over the sockets has
    TCP_TIMEOUT_S: a connection that fails or stalls fails the run, and
    the sockets and the dispatcher are closed either way."""
    from torch.profiler import record_function

    from chalametpir_tpu_torch import kernels
    from chalametpir_tpu_torch.net.framing import read_frame, write_frame
    from chalametpir_tpu_torch.net.server import PirTcpServer

    db, pir_seed, server, hint, fparams, client = set_up(cell, n, seed, dev, rec, checks)
    traffic = stream_of(seed, TRAFFIC)
    per_conn = TCP_PER_CONN + 2  # the warm query, the timed ones, the profiled one
    all_keys = list(db)
    keys = [all_keys[i] for i in traffic.choice(n, size=TCP_CONNS * per_conn, replace=False)]
    with concurrent.futures.ThreadPoolExecutor(QUERY_THREADS) as makers:
        made = make_queries(client, keys, makers)
    max_resp = server.num_response_cols * 4 + 64
    tcp = PirTcpServer(server, pir_seed, hint, fparams, max_batch=TCP_MAX_BATCH)
    dispatcher = tcp._dispatcher
    srv, conns = None, []

    async def connect(port: int):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await reader.readexactly(32)
        await read_frame(reader, 1 << 30)
        await read_frame(reader, 4096)
        return reader, writer

    async def open_conns() -> list:
        port = srv.sockets[0].getsockname()[1]
        return list(await asyncio.gather(*[connect(port) for _ in range(TCP_CONNS)]))

    async def pump(conn, first: int, count: int) -> list:
        reader, writer = conn
        out = []
        for j in range(first, first + count):
            t0 = time.perf_counter()
            write_frame(writer, made[j])
            await writer.drain()
            out.append((j, await read_frame(reader, max_resp), time.perf_counter() - t0))
        return out

    async def each_conn(first: int, count: int) -> list:
        """Queries first..first+count-1 of every connection, the connections
        at once, each closed-loop: (query index, response, seconds) rows.
        One connection's failure cancels the others."""
        async with asyncio.TaskGroup() as group:
            tasks = [group.create_task(pump(conn, c * per_conn + first, count)) for c, conn in enumerate(conns)]
        return [r for task in tasks for r in task.result()]

    async def profiled_round() -> list:
        with record_function("bench.serve"):
            return await each_conn(1 + TCP_PER_CONN, 1)

    async def close() -> None:
        for _, writer in conns:
            writer.close()
        if srv is not None:
            srv.close()
        await dispatcher.aclose()

    with asyncio.Runner() as runner:  # closing it cancels whatever is left on its loop

        def phase(coro):
            return runner.run(asyncio.wait_for(coro, TCP_TIMEOUT_S))

        try:
            srv = phase(asyncio.start_server(tcp.handle, "127.0.0.1", 0))
            conns = phase(open_conns())
            answers = phase(each_conn(0, 1))
            batches0, served0 = dispatcher.batches, dispatcher.served
            t0 = time.perf_counter()
            timed_rows = phase(each_conn(1, TCP_PER_CONN))
            wall = time.perf_counter() - t0
            batches, served = dispatcher.batches - batches0, dispatcher.served - served0
            profiled_rows = []
            profiled = profile_window(lambda: profiled_rows.extend(phase(profiled_round())), dev)
        finally:
            phase(close())
    latencies = [r[2] for r in timed_rows]
    rec.metric("serve_qps", len(latencies) / wall, "1/s")
    rec.metric("serve_ms", median_ms(latencies), "ms")
    p, value = tail(latencies)
    rec.metric(f"serve_p{p}_ms", value * 1e3, "ms")
    rec.layer("serve_batch_mean", served / batches, "queries")
    rec.full["serve_samples_s"] = latencies
    rec.full["profile"] = profiled
    rec.layer("device_idle_share", profiled["device_idle_share"], "1")
    rec.launches = dict(kernels.LAUNCHES)
    log(f"TCP: {len(latencies) / wall:.1f} q/s, median {median_ms(latencies):.3f} ms, p{p} {value * 1e3:.3f} ms, "
        f"{served / batches:.2f} queries a batch; profiled round: device idle {profiled['device_idle_share']}")
    kept = []
    for j, rb, _ in answers + timed_rows + profiled_rows:
        retrieve(client, keys[j], rb, db, checks)
        if len(kept) < 2 * KEPT:
            kept.append((wire_row(made[j]), wire_row(rb)))
    check_batch_vs_single(server, kept, checks)
    b, num_cols = server.mat_elem_bit_len, server.num_response_cols
    del server, client, tcp, dispatcher
    check_on_the_host(cell, seed, db, b, num_cols, fparams, hint, pir_seed, kept, traffic, checks, rec)


MASK32 = (1 << 32) - 1


def plane_value(seed: int, i, j):
    """D[i, j] in 0..255 of the synthetic lo plane: an integer hash of
    (seed, i, j) that numpy on the host and torch on the device compute
    alike, given int64 row and column indices (no product passes 2^63)."""
    x = (i * 0x9E3779B1 + j * 0x85EBCA77 + (seed * 0xC2B2AE3D & MASK32)) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & MASK32
    x = x ^ (x >> 12)
    x = (x * 0x297A2D39) & MASK32
    return (x ^ (x >> 15)) >> 24


def synthetic_lo_plane(seed: int, m: int, cols: int, b: int, dev):
    """A lo plane alone (b <= 8, no hi plane) of m rows and `cols` columns,
    D = plane_value(seed, i, j), filled on `dev` in row slabs; padding rows
    and columns hold value zero, as in served planes."""
    import torch

    from chalametpir_tpu_torch.ops.respond_packed import LANE, M_ALIGN, PackedPlanes

    lo = torch.full((-(-m // M_ALIGN) * M_ALIGN, -(-cols // LANE) * LANE), -128, dtype=torch.int8, device=dev)
    j = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    step = 1 << 16
    for r0 in range(0, m, step):
        i = torch.arange(r0, min(m, r0 + step), dtype=torch.int64, device=dev)[:, None]
        lo[r0 : r0 + i.shape[0], :cols] = (plane_value(seed, i, j) - 128).to(torch.int8)
    return PackedPlanes(lo, None, b, m, cols)


def run_lo(cell: Cell, n: int, seed: int, dev, rec: Record, checks: Checks) -> None:
    """A lo plane alone (b = cell.b <= 8) of the exact serving geometry of an
    n-entry DB, made on the device from the seed (synthetic_lo_plane: the
    respond kernel's work does not depend on the plane's values), then
    `responds` closed-loop server.respond calls, `batches` respond_batch
    calls of random well-formed queries and a profiled window of
    PROFILE_BATCHES more. The check computes the plane's sampled columns
    again on the host from the seed (plane_value in numpy)."""
    from torch.profiler import record_function

    from chalametpir_tpu_torch import Server, kernels
    from chalametpir_tpu_torch.core import codec
    from chalametpir_tpu_torch.core.filter import filter_geometry

    _, _, m = filter_geometry(cell.arity, n)
    cols = codec.encoded_row_width(cell.value_len, cell.b)
    planes, gen_s = timed(lambda: synthetic_lo_plane(seed, m, cols, cell.b, dev), dev)
    rec.metric("plane_gen_s", gen_s, "s")
    rec.full["plane_bytes"] = planes.device_bytes
    server = Server("torch", planes, m, cols, cell.b, "packed")
    traffic = stream_of(seed, TRAFFIC)

    def random_query() -> bytes:
        return row_bytes(traffic.integers(0, 1 << 32, size=m, dtype=np.uint32))

    def respond_loop(count: int, kept: list | None = None) -> list[float]:
        times = []
        for i in range(count):
            qb = random_query()
            with record_function("bench.respond"):
                t0 = time.perf_counter()
                rb = server.respond(qb)
                times.append(time.perf_counter() - t0)
            if kept is not None and i >= WARM and len(kept) < KEPT:
                kept.append((wire_row(qb), wire_row(rb)))
        return times[WARM:] if kept is not None else times

    kept: list = []
    times = respond_loop(WARM + cell.responds, kept)
    rec.metric("respond_ms", median_ms(times), "ms")
    p, value = tail(times)
    rec.metric(f"respond_p{p}_ms", value * 1e3, "ms")
    batch_times = []
    for i in range(1 + cell.batches):
        qmat = traffic.integers(0, 1 << 32, size=(BATCH, m), dtype=np.uint32)
        resp, dt = timed(lambda: server.respond_batch(qmat), dev)
        if i:
            batch_times.append(dt)
    kept += list(zip(qmat[:KEPT], resp[:KEPT]))
    rec.metric("respond_batch_qps", cell.batches * BATCH / sum(batch_times), "1/s")
    rec.full["respond_samples_s"], rec.full["respond_batch_samples_s"] = times, batch_times
    qmats = [traffic.integers(0, 1 << 32, size=(BATCH, m), dtype=np.uint32) for _ in range(PROFILE_BATCHES)]
    batch_profile, _ = profile_batches(server, qmats, dev)
    rec.full["batch_profile"] = batch_profile
    rec.layer(f"upload_q{BATCH}_ms", batch_profile["htod_ms_by_span"].get("bench.respond_batch"), "ms")
    profiled = profile_window(lambda: respond_loop(PROFILE_ROUNDS), dev)
    rec.full["profile"] = profiled
    rec.layer("device_idle_share", profiled["device_idle_share"], "1")
    rec.layer("device_idle_share_in_respond", profiled["respond_idle_share"], "1")
    rec.layer("upload_q1_ms", profiled["htod_ms_by_span"].get("bench.respond"), "ms")
    rec.launches = dict(kernels.LAUNCHES)
    record_kernels(rec, kernel_rows(cell, server, bytes(32), traffic))
    check_batch_vs_single(server, kept, checks)
    sampled = np.sort(traffic.choice(cols, size=SAMPLED_COLS, replace=False))
    d_cols = plane_value(seed, np.arange(m, dtype=np.int64)[:, None], sampled.astype(np.int64)[None, :])
    check_columns(kept, d_cols.astype(np.uint16), sampled, checks)
    rec.correct = checks.correct(("columns", "batch_vs_single"))


RUNNERS = {"serve": run_serve, "tcp": run_tcp, "lo": run_lo}


def run(cell: Cell, seed: int, device: str = "cuda", log_n: int | None = None,
        full_path: str | None = "") -> Record:
    """Run `cell` and return its record (the last line already printed).
    full_path "" writes the full record under FULL_DIR, None writes none."""
    import torch

    from chalametpir_tpu_torch import kernels

    dev = torch.device(device)
    if dev.type == "cuda":
        card = nvidia_smi("name,power.limit")
        kind = torch.cuda.get_device_name(0)
    else:
        card = kind = "cpu"
    if full_path == "":
        suffix = "" if dev.type == "cuda" else f"-cpu-logn{log_n}"
        full_path = os.path.join(FULL_DIR, f"{cell.name}-seed{seed}{suffix}.json")
    rec = Record(cell, seed, card, full_path)
    print(json.dumps({**rec.head, "kind": kind, "why": cell.why[:300], "log_n": log_n or cell.log_n},
                     separators=(",", ":")), flush=True)
    checks = Checks()
    rec.full["checks"] = checks.counts
    if dev.type == "cuda":
        rec.full["kernel_build_s"] = kernels.build()
    t0 = time.perf_counter()
    n = 1 << (log_n or cell.log_n)
    warm_up("stream" if cell.prg_mode == "stream" else "ctr", cell.arity, min(n, 1 << 12), dev, checks)
    kernels.reset_launch_counts()
    rec.full["warm_up_s"] = time.perf_counter() - t0
    try:
        RUNNERS[cell.traffic](cell, n, seed, dev, rec, checks)
    finally:
        gc.unfreeze()
        gc.collect()
    rec.full["query_retries"] = checks.query_retries
    rec.full["host_client_card_use"] = checks.host_card_use
    rec.full["peak_rss_GB"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9  # Linux: KiB
    log(f"checks (checked, wrong): {checks.counts}; host client's card use {checks.host_card_use}; "
        f"correct {rec.correct}; {checks.query_retries} query retries; "
        f"peak RSS {rec.full['peak_rss_GB']:.2f} GB; wall {time.perf_counter() - rec.t0:.1f} s")
    rec.emit("done")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--log-n", type=int, help="log2 of the DB's entries, for the CPU tests (--device cpu only)")
    args = ap.parse_args(argv)
    if args.log_n is not None and args.device != "cpu":
        ap.error("--log-n is for the CPU tests: the card runs each cell at its own size")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (--device cpu runs the plain versions, for the tests)", file=sys.stderr)
        return 2
    try:
        rec = run(CELLS[args.cell], args.seed, args.device, args.log_n)
    except Exception as exc:  # the last line says the run failed; the exit code too
        import traceback

        traceback.print_exc()
        print(json.dumps({"cell": args.cell, "seed": args.seed, "phase": "failed", "correct": False,
                          "error": repr(exc)[:300]}, separators=(",", ":")), flush=True)
        return 1
    return 0 if rec.correct else 1


if __name__ == "__main__":
    sys.exit(main())
