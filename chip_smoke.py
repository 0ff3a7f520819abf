#!/usr/bin/env python3
"""Smoke run of chalametpir_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from csrc/, checks each against its plain
PyTorch version bit for bit (phase 3: the respond kernel's scan and
tensor-core regimes at every hi-plane pack, Q from 1 to 1774, both
regimes on both sides of their crossover, out accumulated twice, the
hint fold's transposed view), then drives eight paths, each with the
launch counts set to 0 just before it and read just after:

- phases 4-5, the ctr-mode serving path through the public entry points
  (Server.setup, Client.setup, client.query, server.respond,
  client.process_response, respond_batch, client save and Client.load) at
  2^20 entries of 32-byte keys and 1 kB values made from --seed, arity 3
  (the reference's headline configuration), every decoded value checked;
  then each kernel timed at the path's shapes beside its plain version and
  its bound, and the two respond regimes side by side from one query to
  64 (diag/respond_regimes.py);
- phases 6-7, the digit-layout respond kernel: against its plain version
  at small shapes, then the scan diagnostic
  (chalametpir_tpu_torch.diag.scan_qd) at the planes of 2^20-2^23 entries,
  with torch._int_mm on the same digits as the library yardstick;
- phase 8, the same serving path at 2^21 entries, where Client.setup
  streams A per batch (StreamingQueryEngine), every decoded value checked;
  then, for the cost of that choice, a client on the resident engine
  (DeviceQueryEngine, 16.7 GB of A planes) beside it: same s . A bit for
  bit, its query() wall and both engines' device time per batch;
- phase 9, the reference-interop deployment, stream PRG mode (A from the
  host XOF, as Rust peers derive it): first 2^14 entries set up on the
  card and with the plain versions on the host, hint, filter, responses
  and s . A equal bit for bit (9a); then the 2^20 DB of phase 4 through
  Server.setup (A folded into the hint by the respond kernel, block by
  block) and Client.setup, each under torch.profiler for the device's
  busy time, single and batched queries, Server.save and Server.load,
  the port's TCP server and client, and the JAX client's host engine,
  Client.setup(device=False), which must launch no kernel and allocate
  nothing on the card (9b), with the ctr Keccak kernel never launched;
- phases 10-11, the sharded server: the 2^20 DB of phase 4 through
  Server.setup(mesh=...) on a 1 x 4 mesh whose shards all lie on this card,
  hint, filter and responses equal to phase 4's byte for byte, the kernels
  held against their plain versions and timed at the shard shapes, sharded
  respond beside unsharded on the same planes (10); 2^14 entries over 1 x 3
  and 2 x 2 meshes, stream and ctr, b = 8 and derived, against the
  unsharded server (10b); then two processes that share this card, each
  with one shard, joined by torch.distributed (gloo): the demo's round
  trip and its TCP serving loop (11);
- phase 12, the digit2 layout and the numpy oracle, which run no
  hand-written kernel (their products are torch._int_mm and numpy's uint64
  matmul): 2^14 entries, arity 3 and 4, stream and ctr, b derived and 13,
  through Server.setup with layout="digit2" and layout="packed" on the
  card, at several hint_block_rows, hint, filter and 40 responses the same
  bytes; backend="numpy" beside them for two of those cases at 2^12
  entries (12a); then the 2^20 DB through Server.setup(layout="digit2") in
  stream mode (the cheaper mode for A off the host: ctr mode would run the
  same Keccak work on one core, with nothing overlapped, and transpose
  8.4 GB after it), hint and responses equal to phase 9b's packed server
  byte for byte, save and load, and the digit2 respond timed beside the
  packed kernel (12b);
- phase 13, the JAX package's call surface: 2^18 entries, arity 3, ctr,
  through Server.setup in the JAX positional order (seed, db, 3, "auto",
  "packed", "ctr"), the same bytes as the keyword call; four client
  engines built as a JAX caller builds them (from_seed_ctr(seed, m,
  32768), from_host_matrix(A), "km" planes through the constructor,
  streaming_from_seed_ctr(seed, m)), the same s . A bit for bit at Q = 1
  and 64, each timed; and the JAX client's host engine, Client(pub_mat_a,
  hint, filt, ...), round-tripping 8 keys;
- phase 14, the bench path: `bench_torch.py --cell ctr-2p20-a3 --seed 9`
  in a process of its own (2^20 entries, ctr, its full traffic: setup,
  client phases, 200 single and 20 batched responds, save and restart),
  which must end correct, with the ctr Keccak kernel and both respond
  regimes in its launch record; its last line is printed here.

Imports nothing of jax or of the JAX package. Prints progress lines and
each phase's wall time, then one JSON line with each kernel's launches on
its paths, its error against the plain version, its time, the plain
version's, the least time the card could take (bytes at the H100's
published memory rate, or operations at its published int8 tensor rate
or at its int32 rate, SMs x 64 lanes x the maximum SM clock read in this
run) and the one library call's time where there is one; then the card's name and
power limit, and last `{"ok": true, "device": {...}}`. Any failure raises
and exits non-zero before the last line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import itertools
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_ENTRIES, VALUE_LEN, ARITY = 1 << 20, 1024, 3
STREAMING_ENTRIES = 1 << 21  # past the resident client planes' budget
STREAM_CHECK_ENTRIES = 1 << 14  # small enough for the plain versions on the host
ORACLE_ENTRIES = 1 << 12  # small enough for the numpy oracle's uint64 matmul on the host
SURFACE_ENTRIES = 1 << 18  # A as host u32 (2.15 GB) for the host engines
DEMO_DEADLINE_S = 180  # each form of the two-process demo
RESPOND_PALLAS = ("chalametpir_tpu/ops/respond_pallas.py:184 (K1, `_kernel_with_hi`), "
                  "chalametpir_tpu/ops/respond_pallas.py:211 (K2, `_kernel_lo_only`)")
SOURCES = {
    "ctr_keccak": ("chalametpir_tpu_torch/csrc/ctr_keccak.cu", "chalametpir_tpu/ops/prg_jax.py:144"),
    "respond_packed_scan": ("chalametpir_tpu_torch/csrc/respond_packed.cu", RESPOND_PALLAS),
    "respond_packed_mma": ("chalametpir_tpu_torch/csrc/respond_packed.cu", RESPOND_PALLAS),
    "respond_digits": ("chalametpir_tpu_torch/csrc/respond_digits.cu",
                       "scripts/diag_scan_qdlayout.py:57 (K4), scripts/diag_scan_qdsweep.py:81 (K5), "
                       "scripts/diag_scan_qdsweep.py:97 (K6)"),
}
BENCH_CELL, BENCH_SEED = "ctr-2p20-a3", 9  # phase 14: bench_torch.py's headline cell
BENCH_DEADLINE_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def build_db(n: int, value_len: int, seed: int) -> dict[bytes, bytes]:
    """n random 32-byte keys -> value_len random bytes, from `seed`
    (bench_torch.build_db: the bench's DB)."""
    from bench_torch import build_db as bench_build_db

    return bench_build_db(n, value_len, np.random.default_rng(seed))


def query(client, key: bytes) -> bytes:
    """client.query, retried on the protocol's rare indicator overflow."""
    from chalametpir_tpu_torch import ArithmeticOverflowAddingQueryIndicator

    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue


def require_launched(names, what: str) -> dict:
    """The launch counts since the last reset; raises unless each kernel
    in `names` ran on the path."""
    from chalametpir_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    missing = [name for name in names if not launches[name]]
    if missing:
        raise AssertionError(f"{', '.join(missing)} never ran on the {what}: {launches}")
    return launches


def digits_bound_ms(row: dict) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of one digit-kernel scan of the
    scan diagnostic (32 digit rows; 24 more against the hi fields for
    b > 8): planes, digits and outputs moved once at the card's memory
    rate, or the int8 products at its int8 tensor rate."""
    from chalametpir_tpu_torch.diag.respond_regimes import CARD_BYTES_PER_S, CARD_INT8_OPS_PER_S
    from chalametpir_tpu_torch.diag.scan_qd import Geometry

    geo = Geometry.of(row["height"])
    hi_rows = 24 if geo.b > 8 else 0
    moved = row["plane_GB"] * 1e9 + 32 * geo.m_pad + 4 * (32 + hi_rows) * geo.c_pad
    by_bytes = moved / CARD_BYTES_PER_S * 1e3
    by_ops = 2 * (32 + hi_rows) * geo.m * geo.c_pad / CARD_INT8_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def as_i32(a) -> "torch.Tensor":
    """A uint32 array as an int32 tensor of the same bits (on the host)."""
    import torch

    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def device_ms(prof) -> str:
    """The device time a torch.profiler run recorded (its CUDA activity),
    split into kernels and memory copies, or "not measured"."""
    if prof is None:
        return "not measured"
    from torch.autograd import DeviceType

    kernels_us = copies_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if e.key.startswith("Memcpy"):
                copies_us += e.self_device_time_total
            else:
                kernels_us += e.self_device_time_total
    return f"kernels {kernels_us / 1e3:.1f} ms, copies {copies_us / 1e3:.1f} ms"


def fetch_over_tcp(server, seed: bytes, hint: bytes, fparams: bytes, keys: list, dev):
    """Serve `server` with the port's TCP server on 127.0.0.1 (a free port)
    and fetch `keys` through the port's client, stream mode, with a pool of
    len(keys) prepared queries; returns (values by key, the dispatcher)."""
    from chalametpir_tpu_torch.net.client import fetch
    from chalametpir_tpu_torch.net.server import PirTcpServer

    tcp = PirTcpServer(server, seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            return await fetch("127.0.0.1", port, keys, prg_mode="stream", device=dev, pool=len(keys))

    return asyncio.run(run()), tcp._dispatcher


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_demo(*args: str) -> subprocess.Popen:
    """The port's two-process demo (parallel/multihost_demo.py), both ranks
    on this card, in a process group of its own so that it can be ended whole."""
    return subprocess.Popen(
        [sys.executable, "-m", "chalametpir_tpu_torch.parallel.multihost_demo", "--launch", "2",
         "--device", "cuda", "--entries", str(STREAM_CHECK_ENTRIES), "--timeout", str(DEMO_DEADLINE_S - 30),
         "--coordinator", f"127.0.0.1:{free_port()}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)


def end_demo(proc: subprocess.Popen, marker: str) -> str:
    """The demo's output once it has ended with code 0 and `marker`; on
    expiry its whole process group is killed and the run fails."""
    try:
        out = proc.communicate(timeout=DEMO_DEADLINE_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raise AssertionError(f"the two-process demo timed out:\n{proc.communicate()[0][-3000:]}")
    if proc.returncode != 0 or marker not in out:
        raise AssertionError(f"the two-process demo failed (rc {proc.returncode}, no {marker!r}?):\n{out[-3000:]}")
    return out


class Errors:
    """Largest |kernel - plain| per kernel, over every comparison made.
    The tolerance is 0: both compute u32 words mod 2^32 exactly."""

    def __init__(self):
        self.max = {name: 0 for name in SOURCES}

    def check(self, name: str, got, want, what: str) -> None:
        import torch

        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        mask = 0xFFFFFFFF
        diff = ((got.to(torch.int64) & mask) - (want.to(torch.int64) & mask)).abs()
        err = int(diff.max().item()) if diff.numel() else 0
        self.max[name] = max(self.max[name], err)
        if err:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = {err}")
        log(f"  {name} {what}: bit-exact (tolerance 0)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from chalametpir_tpu_torch import Client, Server, kernels
    from chalametpir_tpu_torch.core import matrix_io, prg
    from chalametpir_tpu_torch.models.client import RESIDENT_PLANES_MAX_BYTES
    from chalametpir_tpu_torch.native import engine
    from chalametpir_tpu_torch.params import LWE_DIMENSION
    from chalametpir_tpu_torch.diag import respond_regimes, scan_qd
    from chalametpir_tpu_torch.models.server import STREAM_BLOCK_ROWS
    from chalametpir_tpu_torch.ops import digits, prg_torch
    from chalametpir_tpu_torch.ops import respond_digits as rd
    from chalametpir_tpu_torch.ops import respond_packed as rp
    from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine, StreamingQueryEngine
    from chalametpir_tpu_torch.utils import telemetry
    from bench_torch import keccak_bound_ms

    dev = torch.device("cuda")
    cuda_ms = scan_qd.cuda_ms  # one timing definition for every ms printed
    t_all = t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        log(f"{name} wall {now - t_phase:.1f} s")
        t_phase = now

    # -- phase 0: environment ------------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    free, total = torch.cuda.mem_get_info(dev)
    log(f"phase 0 env: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{run([kernels.nvcc_path(), '--version']).splitlines()[-1]} | "
        f"memory free {free / 2**30:.1f} / {total / 2**30:.1f} GiB")

    # -- phase 1: build ------------------------------------------------------
    log(f"phase 1 build: {kernels.build():.1f} s")
    phase_done("phase 1")

    errors = Errors()
    rng = np.random.default_rng(args.seed)

    # -- phase 2: K3 against its references ----------------------------------
    seed = rng.bytes(32)
    words = prg_torch.seed_to_words(seed)
    block0 = (7 << 32) | (0xFFFFFFFF - 5000)  # the low counter word carries mid-run
    nblocks = (1 << 20) + 77
    got = prg_torch.ctr_blocks(words, block0, nblocks, dev)
    errors.check("ctr_keccak", got, prg_torch.ctr_blocks_ref(words, block0, nblocks, dev),
                 f"{nblocks} blocks from {block0:#x} vs plain on the card")
    native = engine.ctr_expand(seed, block0, nblocks).view("<u4").view(np.int32)
    errors.check("ctr_keccak", got.cpu(), torch.from_numpy(native.reshape(nblocks, -1).copy()),
                 "vs the native host engine")
    slab = prg_torch.expand_fp_slab(words, 97, 1024, 1774, dev)  # starts 22 words into a block
    errors.check("ctr_keccak", slab.cpu(), prg_torch.expand_fp_slab(words, 97, 1024, 1774, "cpu"),
                 "mid-block slab vs plain on the host")
    phase_done("phase 2")

    # -- phase 3: K1/K2, both regimes, against the plain version ---------------
    def regime(q: int, b: int) -> str:
        """The name of the respond regime Q queries over a b-bit DB take."""
        return f"respond_packed_{kernels.choose_regime(q, rp.pack_geometry(b, 128)[0])}"

    m, c = 30001, 1000  # multiples of no tile
    crossover = (kernels.MMA_MIN_Q - 1, kernels.MMA_MIN_Q)
    for b in (8, 9, 10, 12, 14):
        mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
        db_planes = rp.build_packed_db(mat, b, dev)
        lo, hi = db_planes.lo, db_planes.hi
        pack = rp.pack_geometry(b, lo.shape[1])[0]
        for q in sorted({1, 2, 5, 8, 15, 16, 17, 64, 1774, *crossover}):
            queries = torch.from_numpy(
                rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32).view(np.int32)).to(dev)
            want = rp.respond_packed_ref(queries, lo, hi, b, c)
            errors.check(regime(q, b), rp.respond_batch_packed(queries, db_planes), want,
                         f"b={b} pack={pack} Q={q} m={m} c={c}")
            if q in crossover or q == 1774:
                # both regimes, out accumulated into twice
                twice = rp._wrap_i32(2 * want.to(torch.int64))
                for name in ("respond_packed_scan", "respond_packed_mma"):
                    out = torch.zeros((q, lo.shape[1]), dtype=torch.int32, device=dev)
                    for _ in range(2):
                        kernels._respond_packed(queries, lo, hi, pack, out, name.rsplit("_", 1)[1])
                    errors.check(name, out[:, :c], twice, f"b={b} Q={q} forced, out accumulated twice")
        # the hint fold's strided, transposed view of an A slab
        slab = torch.from_numpy(
            rng.integers(0, 1 << 32, size=(m, 1774), dtype=np.uint32).view(np.int32)).to(dev)
        errors.check(regime(1774, b), rp.hint_fold_partial(slab.t(), lo, hi, b, c),
                     rp.respond_packed_ref(slab.t(), lo, hi, b, c), f"b={b} fold of a 1774-wide slab's transpose")
        del db_planes, lo, hi, slab, queries
    phase_done("phase 3")

    # -- phase 4: the slice ----------------------------------------------------
    n = NUM_ENTRIES
    t0 = time.perf_counter()
    db = build_db(n, VALUE_LEN, args.seed)
    log(f"phase 4 slice: {n} entries x {VALUE_LEN} B values built in "
        f"{time.perf_counter() - t0:.1f} s")
    pir_seed = rng.bytes(32)
    keys = list(db)
    probe = [keys[int(i)] for i in rng.choice(n, size=16 + 64, replace=False)]

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    filter_rng_state = copy.deepcopy(rng.bit_generator.state)  # phase 10 draws the same filter
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(pir_seed, db, arity=ARITY, prg_mode="ctr",
                                         rng=rng, device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    client = Client.setup(pir_seed, hint, fparams, prg_mode="ctr", device=dev)
    torch.cuda.synchronize()
    client_s = time.perf_counter() - t0
    respond_ms, singles = [], []
    for key in probe[:16]:
        qb = query(client, key)
        t0 = time.perf_counter()
        rb = server.respond(qb)
        respond_ms.append((time.perf_counter() - t0) * 1e3)
        if client.process_response(key, rb) != db[key]:
            raise AssertionError("single query decoded a wrong value")
        singles.append((qb, rb))
    # a client restarted from its archive answers the queries pending at save
    pending = {key: query(client, key) for key in probe[:2]}
    with tempfile.TemporaryDirectory() as tmp:
        client.save(os.path.join(tmp, "client.npz"))
        loaded = Client.load(os.path.join(tmp, "client.npz"), device=dev)
    if loaded._engine.device.type != "cuda":
        raise AssertionError("the loaded client's engine is not on the card")
    for key, qb in pending.items():
        if loaded.process_response(key, server.respond(qb)) != db[key]:
            raise AssertionError("a query pending at client.save decoded a wrong value after load")
    del loaded
    batch_keys = probe[16:]
    client.prepare_queries(len(batch_keys))
    qmat = np.stack([np.frombuffer(qb[8:], "<u4") for qb in client.query_batch(batch_keys)])
    t0 = time.perf_counter()
    resp = server.respond_batch(qmat)
    batch_ms = (time.perf_counter() - t0) * 1e3
    header = np.array([1, resp.shape[1]], "<u4").tobytes()
    for key, row in zip(batch_keys, resp):
        if client.process_response(key, header + row.astype("<u4").tobytes()) != db[key]:
            raise AssertionError("batched query decoded a wrong value")
    torch.cuda.synchronize()
    launches = require_launched(("ctr_keccak", "respond_packed_scan", "respond_packed_mma"),
                                "2^20 serving path")
    planes = server.planes
    if planes.lo.device.type != "cuda" or client._engine.device.type != "cuda":
        raise AssertionError("planes are not on the card")
    log(f"  server setup {setup_s:.2f} s, phases {server.setup_stats['phases_s']}, "
        f"upload {server.setup_stats['upload_bytes']} B; client setup {client_s:.2f} s "
        f"({client.setup_stats['engine']} engine)")
    log(f"  16 single queries, 2 pending across client.save / Client.load and a batch of "
        f"{len(batch_keys)} decoded correctly; launches {launches}")
    log(f"  server.respond median {statistics.median(respond_ms):.3f} ms (Q=1, host wall, "
        f"wire parse included); respond_batch {batch_ms:.3f} ms per batch of {len(batch_keys)}")
    log(f"  device bytes: server planes {planes.device_bytes}, client A planes "
        f"{client._engine.device_bytes}; m={planes.num_rows} c={planes.num_cols} "
        f"b={planes.mat_elem_bit_len}")
    db20 = db  # phase 9 serves the same DB in stream mode, phase 10 sharded
    # what the sharded server of phase 10 must reproduce byte for byte
    unsharded = dict(seed=pir_seed, hint=hint, fparams=fparams, singles=singles, qmat=qmat, resp=resp,
                     rng_state=filter_rng_state, setup_s=setup_s)
    del db, client, server, singles, qmat, resp
    phase_done("phase 4")

    # -- phase 5: kernel vs plain at the main path's shapes -------------------
    ms, plain_ms, library_ms, bound = {}, {}, {}, {}
    copy_rate, int8_rate = scan_qd.copy_gbps(dev), respond_regimes.int8_tops(dev)
    log(f"  bounds at the H100's published {respond_regimes.CARD_BYTES_PER_S / 1e12} TB/s and "
        f"{respond_regimes.CARD_INT8_OPS_PER_S / 1e12:.0f} int8 TOP/s; measured here for reference: "
        f"device-to-device copy {copy_rate:.1f} GB/s (read + write), torch._int_mm on 8192^3 "
        f"{int8_rate:.1f} TOP/s")
    b, mrows, ncols = planes.mat_elem_bit_len, planes.num_rows, planes.num_cols
    for q in (1, 64):
        queries = torch.from_numpy(
            rng.integers(0, 1 << 32, size=(q, mrows), dtype=np.uint32).view(np.int32)).to(dev)
        k_fn = lambda: rp.respond_batch_packed(queries, planes)  # noqa: E731
        p_fn = lambda: rp.respond_packed_ref(queries, planes.lo, planes.hi, b, ncols)  # noqa: E731
        name = regime(q, b)
        errors.check(name, k_fn(), p_fn(), f"respond Q={q} over the served planes")
        k, p = cuda_ms(k_fn, 20), cuda_ms(p_fn, 3)
        shape = (q, mrows, planes.lo.shape[1], planes.device_bytes, b)
        bnd = respond_regimes.bound_ms(*shape)
        log(f"  respond Q={q} ({name}): kernel {k:.3f} ms, plain {p:.3f} ms, bound "
            f"{bnd[0]:.3f} ms ({bnd[1]}; {bnd[0] / k:.1%}); at the measured rates "
            f"{respond_regimes.bound_ms(*shape, copy_rate * 1e9, int8_rate * 1e12)[0]:.3f} ms")
        ms[name], plain_ms[name], bound[name] = k, p, bnd
        library_ms[name] = None  # no torch call computes u32 x packed b-bit mod 2^32
    cc = min(1 << 17, planes.lo.shape[0])
    nblocks = cc * 1774 * 4 // 168 + 2
    k = cuda_ms(lambda: prg_torch.ctr_blocks(words, 0, nblocks, dev), 5)
    p = cuda_ms(lambda: prg_torch.ctr_blocks_ref(words, 0, nblocks, dev), 2)
    errors.check("ctr_keccak", prg_torch.ctr_blocks(words, 0, nblocks, dev),
                 prg_torch.ctr_blocks_ref(words, 0, nblocks, dev), f"{nblocks} blocks (one fold chunk)")
    ms["ctr_keccak"], plain_ms["ctr_keccak"], library_ms["ctr_keccak"] = k, p, None
    bound["ctr_keccak"] = keccak_bound_ms(nblocks)
    log(f"  ctr_keccak {nblocks} blocks (one fold chunk of A): kernel {k:.3f} ms, plain {p:.3f} ms, "
        f"bound {bound['ctr_keccak'][0]:.3f} ms ({bound['ctr_keccak'][1]})")
    a_slab = prg_torch.expand_fp_slab(words, 0, cc, 1774, dev)
    lo_c, hi_c = planes.lo[:cc], planes.hi[:cc] if planes.hi is not None else None
    fold = lambda: rp.hint_fold_partial(a_slab.t(), lo_c, hi_c, b, ncols)  # noqa: E731
    fold_ref = lambda: rp.respond_packed_ref(a_slab.t(), lo_c, hi_c, b, ncols)  # noqa: E731
    errors.check(regime(1774, b), fold(), fold_ref(), f"hint fold 1774 x {cc} x {ncols}")
    k, p = cuda_ms(fold, 3), cuda_ms(fold_ref, 2)
    shape = (1774, cc, lo_c.shape[1], lo_c.numel() + (hi_c.numel() if hi_c is not None else 0), b)
    bnd = respond_regimes.bound_ms(*shape)
    log(f"  hint fold chunk 1774 x {cc} x {ncols}: kernel {k:.3f} ms, plain {p:.3f} ms, bound "
        f"{bnd[0]:.3f} ms ({bnd[1]}; {bnd[0] / k:.1%}); at the measured rates "
        f"{respond_regimes.bound_ms(*shape, copy_rate * 1e9, int8_rate * 1e12)[0]:.3f} ms")
    del planes, queries, a_slab, lo_c, hi_c, k_fn, p_fn, fold, fold_ref
    torch.cuda.empty_cache()
    # both regimes side by side at 2^20 (b = 9) and 2^23 (b = 8): the crossover
    regimes = respond_regimes.run(seed=args.seed, log=lambda line: log(f"  {line}"))
    del regimes
    phase_done("phase 5")

    # -- phase 6: the digit kernel (K4-K6) against its plain version -----------
    # 32, 64 and 96 digit rows (of 96, 72 meet hi: not a multiple of 16), the
    # widths of the 2^20 and the 2^23 planes (1024 and 1152 columns: eight
    # and nine blocks of 128), every pack, both layouts
    m = 30033  # 30,048 digits a row in whole copies: a ragged last stage and split
    for b, c in itertools.product((8, 9, 10, 12, 14), (1000, 1100)):
        mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
        db_planes = rp.build_packed_db(mat, b, dev)
        lo, hi = db_planes.lo, db_planes.hi
        pack = rp.pack_geometry(b, lo.shape[1])[0]
        for q in (8, 16, 24):
            queries = torch.from_numpy(
                rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32).view(np.int32)).to(dev)
            want = rp.respond_packed_ref(queries, lo, hi, b, c)
            qd2, _ = digits.prepare_query_digits(queries, lo.shape[0])
            want_lo, want_hi = rd.respond_digits_ref(qd2, lo, hi, pack)
            # the 2-D digits cut to whole 16-byte copies: a strided view
            view = qd2[:, : -(-m // 16) * 16]
            for layout, qd in (("2d", qd2), ("3d", rd.to_3d(qd2)), (f"2d view of {view.shape[1]} digits", view)):
                what = f"b={b} pack={pack} qd_rows={qd2.shape[0]} {layout} m={m} c={c}"
                out_lo, out_hi = rd.respond_digits(qd, lo, hi, pack)
                errors.check("respond_digits", out_lo, want_lo, f"{what}: out_lo")
                if pack:
                    errors.check("respond_digits", out_hi, want_hi, f"{what}: out_hi")
            for layout in rd.LAYOUTS:
                errors.check("respond_digits", rd.respond_batch_digits(queries, db_planes, layout),
                             want, f"b={b} qd_rows={qd2.shape[0]} {layout}: recombined vs u32 plain")
        del db_planes, lo, hi
    # digits and plane bytes at their extremes, every hi field all ones, over
    # more rows than one split may hold: every partial sum as large as it gets
    m = 33 * rp.M_ALIGN
    if m < kernels.MMA_MAX_SPLIT_ROWS + kernels.DIGIT_ROW_STEP:
        raise AssertionError("the extreme planes do not cross a split")
    for pack, dfill, lfill in itertools.product((0, 1, 2, 4, 8), (-128, 127), (-128, 127)):
        qd2 = torch.full((32, m), dfill, dtype=torch.int8, device=dev)
        lo = torch.full((m, 128), lfill, dtype=torch.int8, device=dev)
        hi = torch.full((m, 128 // max(pack, 1)), 0xFF, dtype=torch.uint8, device=dev) if pack else None
        want_lo, want_hi = rd.respond_digits_ref(qd2, lo, hi, pack)
        field = -1 if pack == 1 else (1 << (8 // max(pack, 1))) - 1  # pack 1 bytes are read as int8
        if not ((want_lo == dfill * lfill * m).all() and (not pack or (want_hi == dfill * field * m).all())):
            raise AssertionError("the plain version misses the closed form of a constant product")
        for layout, qd in (("2d", qd2), ("3d", rd.to_3d(qd2))):
            what = f"pack={pack} digits {dfill} x lo {lfill}, fields all ones, {m} rows, {layout}"
            out_lo, out_hi = rd.respond_digits(qd, lo, hi, pack)
            errors.check("respond_digits", out_lo, want_lo, f"{what}: out_lo")
            if pack:
                errors.check("respond_digits", out_hi, want_hi, f"{what}: out_hi")
    del qd2, lo, hi
    phase_done("phase 6")

    # -- phase 7: the scan diagnostic, the digit kernel's path -----------------
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    scan = scan_qd.run(seed=args.seed, log=lambda line: log(f"  {line}"))
    torch.cuda.synchronize()
    scan_launches = require_launched(("respond_digits", "respond_packed_mma"), "scan diagnostic")
    launches["respond_digits"] = scan_launches["respond_digits"]
    row = next(r for r in scan["rows"] if r["height"] == 20 and r["layout"] == "3d")
    ms["respond_digits"], plain_ms["respond_digits"] = row["ms"], row["plain_ms"]
    library_ms["respond_digits"] = row["int_mm_ms"]
    bound["respond_digits"] = digits_bound_ms(row)
    for r in scan["rows"]:
        if r["layout"] == "3d":
            bnd = digits_bound_ms(r)
            log(f"  2^{r['height']}: torch._int_mm(qd, lo) {r['int_mm_ms']:.3f} ms beside the digit kernel's "
                f"{r['ms']:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]})")
    log("  3-D layout's time over the 2-D layout's, calls in turns: "
        + ", ".join(f"2^{h} {r:.4f}" for h, r in scan["ratio_3d_over_2d"].items()))
    log(f"  every height bit-exact; launches {scan_launches}")
    phase_done("phase 7")

    # -- phase 8: the streaming client at 2^21 entries -------------------------
    n = STREAMING_ENTRIES
    t0 = time.perf_counter()
    db = build_db(n, VALUE_LEN, args.seed + 1)
    log(f"phase 8 streaming: {n} entries x {VALUE_LEN} B values built in "
        f"{time.perf_counter() - t0:.1f} s")
    pir_seed = rng.bytes(32)
    keys = list(db)
    probe = [keys[int(i)] for i in rng.choice(n, size=4 + 64, replace=False)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(pir_seed, db, arity=ARITY, prg_mode="ctr",
                                         rng=rng, device=dev)
    setup_s = time.perf_counter() - t0
    server_k3 = kernels.LAUNCHES["ctr_keccak"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    client = Client.setup(pir_seed, hint, fparams, prg_mode="ctr", device=dev)
    client_s = time.perf_counter() - t0
    m = server.num_query_cols
    engine_name = client.setup_stats["engine"]
    log(f"  Client.setup picked the {engine_name} engine ({type(client._engine).__name__}): "
        f"resident A planes would be 4 * {m} * {LWE_DIMENSION} = {4 * m * LWE_DIMENSION} B "
        f"> RESIDENT_PLANES_MAX_BYTES {RESIDENT_PLANES_MAX_BYTES}")
    if engine_name != "streaming" or not isinstance(client._engine, StreamingQueryEngine):
        raise AssertionError(f"Client.setup at 2^21 picked the {engine_name} engine")
    query_ms, respond_ms = [], []
    for key in probe[:4]:
        t0 = time.perf_counter()
        qb = query(client, key)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        rb = server.respond(qb)
        respond_ms.append((time.perf_counter() - t0) * 1e3)
        if client.process_response(key, rb) != db[key]:
            raise AssertionError("2^21 single query decoded a wrong value")
    batch_keys = probe[4:]
    t0 = time.perf_counter()
    client.prepare_queries(len(batch_keys))
    prepare_s = time.perf_counter() - t0
    qmat = np.stack([np.frombuffer(qb[8:], "<u4") for qb in client.query_batch(batch_keys)])
    resp = server.respond_batch(qmat)
    header = np.array([1, resp.shape[1]], "<u4").tobytes()
    for key, row in zip(batch_keys, resp):
        if client.process_response(key, header + row.astype("<u4").tobytes()) != db[key]:
            raise AssertionError("2^21 batched query decoded a wrong value")
    torch.cuda.synchronize()
    stream_launches = require_launched(("ctr_keccak", "respond_packed_scan", "respond_packed_mma"),
                                       "2^21 streaming path")
    client_k3 = stream_launches["ctr_keccak"] - server_k3
    if client_k3 <= 0:
        raise AssertionError("the streaming client never launched the ctr Keccak kernel")
    log(f"  server setup {setup_s:.2f} s, phases {server.setup_stats['phases_s']}; "
        f"client setup {client_s:.3f} s; m={m} b={server.mat_elem_bit_len}")
    log(f"  4 single queries and a prepared batch of {len(batch_keys)} decoded correctly; "
        f"query() wall {', '.join(f'{t:.1f}' for t in query_ms)} ms; server.respond median "
        f"{statistics.median(respond_ms):.3f} ms; prepare_queries({len(batch_keys)}) {prepare_s:.3f} s")
    log(f"  launches {stream_launches}, of which the client's K3 {client_k3}; device peak during "
        f"the client's work {torch.cuda.max_memory_allocated(dev)} B, server planes "
        f"{server.planes.device_bytes} B")
    # the resident engine at the same m, which the rule turned down
    t0 = time.perf_counter()
    resident = Client(None, client._hint_mat_m, client._filter,
                      DeviceQueryEngine.from_seed_ctr(pir_seed, m, device=dev), pir_seed, "ctr")
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    resident_query_ms = []
    for key in probe[:4]:
        t0 = time.perf_counter()
        qb = query(resident, key)
        resident_query_ms.append((time.perf_counter() - t0) * 1e3)
        if resident.process_response(key, server.respond(qb)) != db[key]:
            raise AssertionError("2^21 resident-engine query decoded a wrong value")
    log(f"  resident engine beside it: {resident._engine.device_bytes} B of A planes built in "
        f"{resident_s:.3f} s; query() wall {', '.join(f'{t:.1f}' for t in resident_query_ms)} ms")
    for q in (1, 64):
        codes = rng.integers(0, 3, size=(q, LWE_DIMENSION)).astype(np.int8)
        if not np.array_equal(client._engine.matvec_batch(codes), resident._engine.matvec_batch(codes)):
            raise AssertionError(f"streaming and resident s.A differ at Q={q}")
        k = cuda_ms(lambda: client._engine.matvec_batch_async(codes), 3)
        r = cuda_ms(lambda: resident._engine.matvec_batch_async(codes), 5)
        log(f"  s.A, Q={q}, equal on both engines: streaming {k:.2f} ms of device time per batch "
            f"({-(-m // client._engine.cols_per_step)} slabs), resident {r:.2f} ms")
    del db, client, resident, server
    torch.cuda.empty_cache()
    phase_done("phase 8")

    # -- phase 9a: stream mode on the card against the plain versions --------
    n = STREAM_CHECK_ENTRIES
    db = build_db(n, VALUE_LEN, args.seed + 2)
    pir_seed = rng.bytes(32)
    built = {}
    for where in (dev, "cpu"):
        server, hint, fparams = Server.setup(pir_seed, db, arity=ARITY, rng=np.random.default_rng(args.seed),
                                             device=where)
        built[where] = server, hint, fparams, Client.setup(pir_seed, hint, fparams, device=where)
    (gpu_server, hint, fparams, gpu_client), (cpu_server, cpu_hint, cpu_fparams, cpu_client) = built.values()
    errors.check(regime(STREAM_BLOCK_ROWS, gpu_server.mat_elem_bit_len), as_i32(matrix_io.matrix_from_bytes(hint)),
                 as_i32(matrix_io.matrix_from_bytes(cpu_hint)), f"stream hint, {n} entries, card vs plain")
    if (hint, fparams) != (cpu_hint, cpu_fparams):
        raise AssertionError("stream-mode hint or filter bytes differ between the card and the plain versions")
    m = gpu_server.num_query_cols
    for q in (1, 64):
        queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
        errors.check(regime(q, gpu_server.mat_elem_bit_len), as_i32(gpu_server.respond_batch(queries)),
                     as_i32(cpu_server.respond_batch(queries)), f"stream respond_batch Q={q}, card vs plain")
        codes = rng.integers(0, 3, size=(q, LWE_DIMENSION)).astype(np.int8)
        if not np.array_equal(gpu_client._engine.matvec_batch(codes), cpu_client._engine.matvec_batch(codes)):
            raise AssertionError(f"stream-mode s.A differs between the card and the host at Q={q}")
    log(f"  {n} entries, m={m}: s.A equal at Q=1 and 64 on both engines "
        f"(client planes {gpu_client._engine.device_bytes} B built from the host XOF's row blocks)")
    del db, built, gpu_server, gpu_client, cpu_server, cpu_client
    phase_done("phase 9a")

    # -- phase 9b: the reference-interop deployment at 2^20 ------------------
    n, db = NUM_ENTRIES, db20
    pir_seed = rng.bytes(32)
    keys = list(db)
    probe = [keys[int(i)] for i in rng.choice(n, size=16 + 64 + 4 + 8, replace=False)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    interop_rng_state = copy.deepcopy(rng.bit_generator.state)  # phase 12b draws the same filter
    # both setups run under torch.profiler, for the device's busy time
    with tempfile.TemporaryDirectory() as tmp:
        with telemetry.profile_to(os.path.join(tmp, "server")) as prof:
            t0 = time.perf_counter()
            server, hint, fparams = Server.setup(pir_seed, db, arity=ARITY, rng=rng, device=dev)
            setup_s = time.perf_counter() - t0
        server_device = device_ms(prof)
        with telemetry.profile_to(os.path.join(tmp, "client")) as prof:
            t0 = time.perf_counter()
            client = Client.setup(pir_seed, hint, fparams, device=dev)
            torch.cuda.synchronize()
            client_s = time.perf_counter() - t0
        client_device = device_ms(prof)
        del prof
    query_ms, respond_ms, singles = [], [], []
    for key in probe[:16]:
        t0 = time.perf_counter()
        qb = query(client, key)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        rb = server.respond(qb)
        respond_ms.append((time.perf_counter() - t0) * 1e3)
        if client.process_response(key, rb) != db[key]:
            raise AssertionError("stream-mode single query decoded a wrong value")
        singles.append((qb, rb))
    batch_keys = probe[16:80]
    client.prepare_queries(len(batch_keys))
    qmat = np.stack([np.frombuffer(qb[8:], "<u4") for qb in client.query_batch(batch_keys)])
    t0 = time.perf_counter()
    resp = server.respond_batch(qmat)
    batch_ms = (time.perf_counter() - t0) * 1e3
    header = np.array([1, resp.shape[1]], "<u4").tobytes()
    for key, row in zip(batch_keys, resp):
        if client.process_response(key, header + row.astype("<u4").tobytes()) != db[key]:
            raise AssertionError("stream-mode batched query decoded a wrong value")
    torch.cuda.synchronize()
    interop_launches = require_launched(("respond_packed_scan", "respond_packed_mma"), "2^20 stream-mode path")
    if interop_launches["ctr_keccak"]:
        raise AssertionError(f"the ctr Keccak kernel ran on the stream-mode path: {interop_launches}")
    planes = server.planes
    b, mrows, ncols = planes.mat_elem_bit_len, planes.num_rows, planes.num_cols
    log(f"  server setup {setup_s:.2f} s, stats {server.setup_stats}; device busy: {server_device}")
    log(f"  client setup {client_s:.2f} s, stats {client.setup_stats}; device busy: {client_device}")
    log(f"  16 single queries and a prepared batch of {len(batch_keys)} decoded correctly; query() wall "
        f"median {statistics.median(query_ms):.1f} ms (range {min(query_ms):.1f}-{max(query_ms):.1f}); "
        f"server.respond median {statistics.median(respond_ms):.3f} ms; respond_batch {batch_ms:.3f} ms "
        f"per batch of {len(batch_keys)}; launches {interop_launches}")
    # the hint of the first two A row blocks against the plain version
    r = STREAM_BLOCK_ROWS
    a_rows = np.concatenate([blk for _, blk in itertools.islice(
        prg.iter_row_blocks(LWE_DIMENSION, mrows, pir_seed, r, mode="stream"), 2)])
    a_dev = as_i32(a_rows).to(dev)
    errors.check(regime(r, b), as_i32(matrix_io.matrix_from_bytes(hint)[: 2 * r]).to(dev),
                 rp.respond_packed_ref(a_dev, planes.lo, planes.hi, b, ncols),
                 f"stream hint rows 0-{2 * r - 1} vs plain on the card")
    fold = lambda: rp.respond_packed_core(a_dev[:r], planes.lo, planes.hi, b, ncols)  # noqa: E731
    fold_ref = lambda: rp.respond_packed_ref(a_dev[:r], planes.lo, planes.hi, b, ncols)  # noqa: E731
    k, p = cuda_ms(fold, 20), cuda_ms(fold_ref, 3)
    bnd = respond_regimes.bound_ms(r, mrows, planes.lo.shape[1], planes.device_bytes, b)
    log(f"  stream hint fold, one block of {r} A rows over the served planes ({regime(r, b)}): kernel "
        f"{k:.3f} ms, plain {p:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}; {bnd[0] / k:.1%}); "
        f"{-(-LWE_DIMENSION // r)} blocks per setup")
    del a_dev, fold, fold_ref, planes

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "server.npz")
        t0 = time.perf_counter()
        server.save(path)
        save_s = time.perf_counter() - t0
        archive_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = Server.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if loaded.planes.lo.device.type != "cuda":
        raise AssertionError("Server.load put the planes off the card")
    for key in probe[80:84]:
        qb = query(client, key)
        rb = server.respond(qb)
        if loaded.respond(qb) != rb:
            raise AssertionError("the loaded server's response bytes differ")
        if client.process_response(key, rb) != db[key]:
            raise AssertionError("stream-mode query decoded a wrong value before save/load")
    log(f"  Server.save {save_s:.2f} s ({archive_bytes} B archive), Server.load {load_s:.2f} s; "
        f"4 responses byte-identical")
    # the reference's interop peer, as bench.py sets it up: the host engine
    # (A in host memory, s . A by the native ternary matvec), which must
    # launch no kernel and allocate nothing on the card
    del client
    torch.cuda.synchronize()
    card_before = dict(kernels.LAUNCHES), torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    t0 = time.perf_counter()
    host_client = Client.setup(pir_seed, hint, fparams, device=False)
    host_setup_s = time.perf_counter() - t0
    if host_client.uses_device or host_client.setup_stats["engine"] != "host":
        raise AssertionError(f"Client.setup(device=False) built a device engine: {host_client.setup_stats}")
    host_keys = probe[80:84]
    host_client.prepare_queries(len(host_keys))
    host_matvec_ms = host_client.prepare_stats["host_matvec_s"] / len(host_keys) * 1e3
    host_queries = [query(host_client, key) for key in host_keys]
    card_after = dict(kernels.LAUNCHES), torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    if card_after != card_before:
        raise AssertionError(f"the host client used the card: launches and allocations {card_before} -> "
                             f"{card_after}")
    for key, qb in zip(host_keys, host_queries):
        if host_client.process_response(key, server.respond(qb)) != db[key]:
            raise AssertionError("the host client decoded a wrong value")
    log(f"  host client (device=False): setup {host_setup_s:.2f} s, stats {host_client.setup_stats}; host matvec "
        f"{host_matvec_ms:.1f} ms a query ({host_client.prepare_stats}); {len(host_keys)} keys round-tripped; "
        f"no launch and no card allocation")
    del host_client, server
    torch.cuda.empty_cache()
    tcp_keys = probe[84:]
    t0 = time.perf_counter()
    values, dispatcher = fetch_over_tcp(loaded, pir_seed, hint, fparams, tcp_keys, dev)
    tcp_s = time.perf_counter() - t0
    if [values.get(key) for key in tcp_keys] != [db[key] for key in tcp_keys]:
        raise AssertionError("a value fetched over TCP did not decode")
    torch.cuda.synchronize()
    persist_launches = require_launched(("respond_packed_scan",), "stream-mode save/load and TCP path")
    if persist_launches["ctr_keccak"]:
        raise AssertionError(f"the ctr Keccak kernel ran on the stream-mode path: {persist_launches}")
    log(f"  TCP: {len(tcp_keys)} keys fetched and decoded in {tcp_s:.2f} s through the port's server and "
        f"client (setup with the host XOF included); dispatcher batches {dispatcher.batches}, served "
        f"{dispatcher.served}; launches {persist_launches}")
    for name in ("respond_packed_scan", "respond_packed_mma"):
        launches[name] += stream_launches[name] + interop_launches[name] + persist_launches[name]
    launches["ctr_keccak"] += stream_launches["ctr_keccak"]
    # what the digit2 server of phase 12b must reproduce byte for byte, and
    # the packed server (the loaded one: 1.36 GB of planes) to time beside it
    interop = dict(seed=pir_seed, hint=hint, fparams=fparams, singles=singles, qmat=qmat, resp=resp,
                   rng_state=interop_rng_state, setup_s=setup_s, packed=loaded)
    del db, loaded, singles, qmat, resp
    torch.cuda.empty_cache()
    phase_done("phase 9b")

    # -- phase 10: the sharded server at 2^20, every shard on this card --------
    from chalametpir_tpu_torch.parallel import make_mesh, sharded_respond_packed_fn
    from chalametpir_tpu_torch.parallel import sharding

    mesh = make_mesh(["cuda:0"] * 4, data=1, model=4)
    filter_rng = np.random.default_rng()
    filter_rng.bit_generator.state = unsharded["rng_state"]
    pir_seed = unsharded["seed"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(pir_seed, db20, arity=ARITY, prg_mode="ctr", rng=filter_rng, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if fparams != unsharded["fparams"]:
        raise AssertionError("the sharded setup's filter bytes differ from phase 4's")
    errors.check("respond_packed_mma", as_i32(matrix_io.matrix_from_bytes(hint)),
                 as_i32(matrix_io.matrix_from_bytes(unsharded["hint"])), "sharded ctr hint vs the unsharded server's")
    if hint != unsharded["hint"]:
        raise AssertionError("the sharded setup's hint bytes differ from phase 4's")
    respond_ms = []
    for qb, rb in unsharded["singles"]:
        t0 = time.perf_counter()
        got = server.respond(qb)
        respond_ms.append((time.perf_counter() - t0) * 1e3)
        if got != rb:
            raise AssertionError("a sharded response differs from the unsharded server's")
    t0 = time.perf_counter()
    resp = server.respond_batch(unsharded["qmat"])
    batch_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(resp, unsharded["resp"]):
        raise AssertionError("the sharded respond_batch differs from the unsharded server's")
    client = Client.setup(pir_seed, hint, fparams, prg_mode="ctr", device=dev)
    key = next(iter(db20))
    if client.process_response(key, server.respond(query(client, key))) != db20[key]:
        raise AssertionError("the sharded server's response decoded a wrong value")
    torch.cuda.synchronize()
    sharded_launches = require_launched(("ctr_keccak", "respond_packed_scan", "respond_packed_mma"),
                                        "sharded 2^20 path")
    planes, dev0 = server.planes, torch.device("cuda", 0)
    if list(planes.runs) != [dev0]:
        raise AssertionError(f"the shards are not on the card: {list(planes.runs)}")
    b, ncols, m_local = planes.mat_elem_bit_len, planes.num_cols, planes.m_local
    cc = sharding._sharded_chunk_rows(m_local, rp.M_ALIGN)
    log(f"  sharded setup, 1x4 mesh on cuda:0: {setup_s:.2f} s (unsharded, phase 4: {unsharded['setup_s']:.2f} s), "
        f"phases {server.setup_stats['phases_s']}; m_pad={planes.m_pad} m_local={m_local}, "
        f"{m_local // cc} fold chunks of {cc} rows a shard")
    log(f"  hint, filter, {len(respond_ms)} responses and a respond_batch of {len(resp)} byte-identical to "
        f"phase 4's, a key decoded; server.respond median {statistics.median(respond_ms):.3f} ms, "
        f"respond_batch {batch_ms:.3f} ms (host wall); launches {sharded_launches}")
    del client, resp
    # the kernels at the shard shapes: chunk 1 of shard 1 starts mid-stream
    col0 = m_local + cc
    block0, offset = prg_torch.fp_block_start(col0, LWE_DIMENSION)
    nblocks = cc * LWE_DIMENSION * 4 // 168 + 2
    pir_words = prg_torch.seed_to_words(pir_seed)
    errors.check("ctr_keccak", prg_torch.ctr_blocks(pir_words, block0, nblocks, dev),
                 prg_torch.ctr_blocks_ref(pir_words, block0, nblocks, dev),
                 f"{nblocks} blocks from block {block0} (shard 1, chunk 1; word offset {offset})")
    k = cuda_ms(lambda: prg_torch.ctr_blocks(pir_words, block0, nblocks, dev), 5)
    p = cuda_ms(lambda: prg_torch.ctr_blocks_ref(pir_words, block0, nblocks, dev), 2)
    bnd = keccak_bound_ms(nblocks)
    log(f"  ctr_keccak at the shard shape, {nblocks} blocks: kernel {k:.3f} ms, plain {p:.3f} ms, bound "
        f"{bnd[0]:.3f} ms ({bnd[1]}; {bnd[0] / k:.1%}); {4 * (m_local // cc)} launches per sharded setup")
    a_slab = prg_torch.expand_fp_slab(pir_words, col0, cc, LWE_DIMENSION, dev)
    lo_s, hi_s = planes.shard(1, dev0)
    lo_c, hi_c = lo_s[cc : 2 * cc], hi_s[cc : 2 * cc] if hi_s is not None else None
    fold = lambda: rp.hint_fold_partial(a_slab.t(), lo_c, hi_c, b, ncols)  # noqa: E731
    fold_ref = lambda: rp.respond_packed_ref(a_slab.t(), lo_c, hi_c, b, ncols)  # noqa: E731
    errors.check(regime(LWE_DIMENSION, b), fold(), fold_ref(), f"sharded hint fold {LWE_DIMENSION} x {cc} x {ncols}")
    k, p = cuda_ms(fold, 3), cuda_ms(fold_ref, 2)
    bnd = respond_regimes.bound_ms(LWE_DIMENSION, cc, lo_c.shape[1],
                                   lo_c.numel() + (hi_c.numel() if hi_c is not None else 0), b)
    log(f"  sharded hint fold chunk {LWE_DIMENSION} x {cc} x {ncols}: kernel {k:.3f} ms, plain {p:.3f} ms, bound "
        f"{bnd[0]:.3f} ms ({bnd[1]}; {bnd[0] / k:.1%}); {4 * (m_local // cc)} launches per sharded setup")
    del a_slab, lo_c, hi_c, fold, fold_ref
    # respond, sharded beside unsharded, on the same planes (one tensor on the card)
    _, lo_all, hi_all = planes.runs[dev0]
    sharded_fn = sharded_respond_packed_fn(mesh, planes)
    for q in (1, 64):
        queries = torch.from_numpy(
            rng.integers(0, 1 << 32, size=(q, planes.m_pad), dtype=np.uint32).view(np.int32)).to(dev0)
        one_fn = lambda: rp.respond_packed_core(queries, lo_all, hi_all, b, ncols)  # noqa: E731
        many_fn = lambda: sharded_fn(queries)  # noqa: E731
        errors.check(regime(q, b), many_fn(), rp.respond_packed_ref(queries, lo_all, hi_all, b, ncols),
                     f"sharded respond Q={q}, 4 shards of {m_local} rows")
        one_a, many_a, many_b, one_b = cuda_ms(one_fn, 20), cuda_ms(many_fn, 20), cuda_ms(many_fn, 20), cuda_ms(one_fn, 20)
        shard_fn = lambda: rp.respond_packed_core(queries[:, m_local : 2 * m_local], lo_s, hi_s, b, ncols)  # noqa: E731
        shard_ref = lambda: rp.respond_packed_ref(queries[:, m_local : 2 * m_local], lo_s, hi_s, b, ncols)  # noqa: E731
        shard_bnd = respond_regimes.bound_ms(q, m_local, lo_all.shape[1], planes.device_bytes // 4, b)
        log(f"  respond Q={q} over the same planes: unsharded (1 launch) {one_a:.3f}, {one_b:.3f} ms; sharded "
            f"(4 launches into one buffer) {many_a:.3f}, {many_b:.3f} ms; one shard's launch "
            f"{cuda_ms(shard_fn, 20):.3f} ms, plain {cuda_ms(shard_ref, 3):.3f} ms, bound {shard_bnd[0]:.3f} ms "
            f"({shard_bnd[1]}), of the four {4 * shard_bnd[0]:.3f} ms")
    del server, planes, lo_all, hi_all, lo_s, hi_s, sharded_fn, queries, one_fn, many_fn, shard_fn, shard_ref, unsharded
    torch.cuda.empty_cache()
    phase_done("phase 10")

    # -- phase 10b: stream mode and the awkward geometries, small --------------
    n = STREAM_CHECK_ENTRIES
    db = build_db(n, VALUE_LEN, args.seed + 2)
    pir_seed = rng.bytes(32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for mode, b in itertools.product(("stream", "ctr"), (None, 8)):
        kw = dict(arity=ARITY, prg_mode=mode, mat_elem_bit_len=b)
        one, one_hint, one_fparams = Server.setup(pir_seed, db, rng=np.random.default_rng(args.seed), device=dev, **kw)
        batches = [rng.integers(0, 1 << 32, size=(q, one.num_query_cols), dtype=np.uint32) for q in (1, 3, 64)]
        want = [one.respond_batch(queries) for queries in batches]
        for shape in ((1, 3), (2, 2)):
            mesh = make_mesh(["cuda:0"] * (shape[0] * shape[1]), data=shape[0], model=shape[1])
            server, hint, fparams = Server.setup(pir_seed, db, rng=np.random.default_rng(args.seed), mesh=mesh, **kw)
            what = f"{mode} b={server.mat_elem_bit_len} mesh {shape[0]}x{shape[1]} m_pad={server.planes.m_pad}"
            errors.check(regime(LWE_DIMENSION, server.mat_elem_bit_len), as_i32(matrix_io.matrix_from_bytes(hint)),
                         as_i32(matrix_io.matrix_from_bytes(one_hint)), f"{what}: hint vs unsharded")
            if (hint, fparams) != (one_hint, one_fparams):
                raise AssertionError(f"{what}: hint or filter bytes differ from the unsharded server's")
            for queries, resp in zip(batches, want):
                errors.check(regime(len(queries), server.mat_elem_bit_len), as_i32(server.respond_batch(queries)),
                             as_i32(resp), f"{what}: respond_batch Q={len(queries)} vs unsharded")
        del one, server
    torch.cuda.synchronize()
    small_launches = require_launched(("ctr_keccak", "respond_packed_scan", "respond_packed_mma"),
                                      "sharded 2^14 paths")
    log(f"  {n} entries, stream and ctr, b derived and 8, meshes 1x3 and 2x2 on cuda:0: hint, filter and "
        f"responses equal to the unsharded server's; launches {small_launches}")
    for name in ("ctr_keccak", "respond_packed_scan", "respond_packed_mma"):
        launches[name] += sharded_launches[name] + small_launches[name]
    del db
    torch.cuda.empty_cache()
    phase_done("phase 10b")

    # -- phase 11: two processes that share this card --------------------------
    # both forms of the demo at once: four processes, most of whose time is
    # their start (imports, CUDA contexts)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "port")
        demos = [start_demo(), start_demo("--tcp-queries", "2", "--port-file", port_file)]
        try:
            deadline = time.monotonic() + DEMO_DEADLINE_S
            while not os.path.exists(port_file) and demos[1].poll() is None and time.monotonic() < deadline:
                time.sleep(0.1)
            if not os.path.exists(port_file):
                raise AssertionError("the demo's leader never published its TCP port:\n"
                                     + end_demo(demos[1], "TCP_PORT")[-3000:])
            from chalametpir_tpu_torch.net.client import fetch
            from chalametpir_tpu_torch.utils import generate_random_kv_database

            # the DB the demo's ranks build
            demo_db = generate_random_kv_database(STREAM_CHECK_ENTRIES, rng=np.random.default_rng(0xD157),
                                                  value_byte_len=(1, 64))
            demo_keys = sorted(demo_db)[:2]
            with open(port_file) as f:
                port = int(f.read())
            values = asyncio.run(fetch("127.0.0.1", port, demo_keys, prg_mode="ctr", device=dev))
            if values != {key: demo_db[key] for key in demo_keys}:
                raise AssertionError("a value fetched from the two-process server did not decode")
            outs = [end_demo(demos[0], "MULTIHOST OK"), end_demo(demos[1], "MULTIHOST TCP OK")]
        finally:
            for proc in demos:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.communicate()
    for out in outs:
        log("  " + "\n  ".join(line for line in out.splitlines() if line.startswith(("[p", "MULTIHOST", "TCP_PORT"))))
    log(f"  two ranks on cuda:0 (gloo), twice, side by side: sharded ctr setup, broadcast query, collective "
        f"respond, decoded; and the leader serving TCP, 2 keys fetched through net.client.fetch and decoded, "
        f"the worker released; {time.perf_counter() - t0:.1f} s")
    phase_done("phase 11")

    # -- phase 12a: the digit2 layout and the numpy oracle, small --------------
    from chalametpir_tpu_torch.ops import respond as respond_ops

    pir_seed = rng.bytes(32)

    def same_bytes(db, arity, mode, b, others: dict) -> str:
        """Server.setup with each of `others` (name -> keywords) beside the
        packed layout on the card: hint, filter and 40 responses must be
        the same bytes, the torch servers' planes on the card, the oracle's
        D on the host."""
        def setup(**kw):
            return Server.setup(pir_seed, db, arity=arity, prg_mode=mode, mat_elem_bit_len=b,
                                rng=np.random.default_rng(args.seed), device=dev, **kw)

        packed, hint, fparams = setup(layout="packed")
        queries = rng.integers(0, 1 << 32, size=(40, packed.num_query_cols), dtype=np.uint32)
        want = packed.respond_batch(queries)
        what = f"{len(db)} entries, arity {arity}, {mode}, b={packed.mat_elem_bit_len}"
        for name, kw in others.items():
            server, other_hint, other_fparams = setup(**kw)
            if kw.get("backend") == "numpy":
                if not isinstance(server.planes, np.ndarray) or server.device.type != "cpu":
                    raise AssertionError(f"{what}: the numpy oracle is not on the host")
            elif server.device.type != "cuda":
                raise AssertionError(f"{what}, {name}: planes are not on the card")
            if kw.get("layout") == "digit2" and (server.layout, server.planes.d0.device.type) != ("digit2", "cuda"):
                raise AssertionError(f"{what}, {name}: not digit planes on the card")
            if (other_hint, other_fparams) != (hint, fparams):
                raise AssertionError(f"{what}, {name}: hint or filter bytes differ from the packed server's")
            if not np.array_equal(server.respond_batch(queries), want):
                raise AssertionError(f"{what}, {name}: responses differ from the packed server's")
        return f"{what}: packed = {' = '.join(others)}: hint, filter and 40 responses byte-identical"

    db = build_db(STREAM_CHECK_ENTRIES, VALUE_LEN, args.seed + 2)
    block_rows = itertools.cycle((1, 7, 1774))
    for arity, mode, b in itertools.product((3, 4), ("stream", "ctr"), (None, 13)):
        r = next(block_rows)
        log("  " + same_bytes(db, arity, mode, b, {
            "digit2": dict(layout="digit2"),
            f"digit2, hint_block_rows={r}": dict(layout="digit2", hint_block_rows=r),
            f"packed, hint_block_rows={r}": dict(layout="packed", hint_block_rows=r)}))
    # the oracle's hint is one uint64 numpy matmul, 1774 x m x c, on one
    # core: at 2^14 entries a setup took 107-133 s on the host of an H100
    # machine, so its two cases (both arities, modes and widths between
    # them) run at 2^12 entries, the values as wide as everywhere
    db = build_db(ORACLE_ENTRIES, VALUE_LEN, args.seed + 3)
    for arity, mode, b in ((3, "stream", None), (4, "ctr", 13)):
        t0 = time.perf_counter()
        line = same_bytes(db, arity, mode, b, {"numpy": dict(backend="numpy"), "digit2": dict(layout="digit2")})
        log(f"  {line} ({time.perf_counter() - t0:.1f} s)")
    del db
    torch.cuda.empty_cache()
    phase_done("phase 12a")

    # -- phase 12b: the digit2 layout at 2^20, beside phase 9b's packed server --
    filter_rng = np.random.default_rng()
    filter_rng.bit_generator.state = interop["rng_state"]
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(interop["seed"], db20, arity=ARITY, prg_mode="stream", rng=filter_rng,
                                         device=dev, layout="digit2")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    planes, packed = server.planes, interop["packed"]
    if (server.layout, planes.d0.device.type, planes.d1.device.type) != ("digit2", "cuda", "cuda"):
        raise AssertionError("the digit2 planes are not on the card")
    if (hint, fparams) != (interop["hint"], interop["fparams"]):
        raise AssertionError("the digit2 setup's hint or filter bytes differ from phase 9b's packed server's")
    respond_ms = []
    for qb, rb in interop["singles"]:
        t0 = time.perf_counter()
        got = server.respond(qb)
        respond_ms.append((time.perf_counter() - t0) * 1e3)
        if got != rb:
            raise AssertionError("a digit2 response differs from the packed server's")
    t0 = time.perf_counter()
    resp = server.respond_batch(interop["qmat"])
    batch_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(resp, interop["resp"]):
        raise AssertionError("the digit2 respond_batch differs from the packed server's")
    log(f"  Server.setup(layout=\"digit2\"), stream mode: {setup_s:.2f} s (packed, phase 9b: "
        f"{interop['setup_s']:.2f} s), stats {server.setup_stats}")
    log(f"  hint, filter, {len(respond_ms)} responses and a respond_batch of {len(resp)} byte-identical to the "
        f"packed server's; planes {planes.device_bytes} B on {planes.device}; server.respond median "
        f"{statistics.median(respond_ms):.3f} ms, respond_batch {batch_ms:.3f} ms (host wall)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "digit2.npz")
        t0 = time.perf_counter()
        server.save(path)
        save_s = time.perf_counter() - t0
        archive_bytes = os.path.getsize(path)
        del server, planes
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        server = Server.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    planes = server.planes
    if (server.layout, planes.d0.device.type) != ("digit2", "cuda"):
        raise AssertionError("Server.load did not rebuild the digit2 planes on the card")
    if any(server.respond(qb) != rb for qb, rb in interop["singles"][:4]) or not np.array_equal(
            server.respond_batch(interop["qmat"]), interop["resp"]):
        raise AssertionError("the loaded digit2 server's responses differ")
    log(f"  Server.save {save_s:.2f} s ({archive_bytes} B archive), Server.load {load_s:.2f} s; 4 responses and "
        f"the batch byte-identical")
    # the digit2 respond (torch._int_mm, no hand-written kernel) beside the packed kernel, in turns
    for q in (1, 64):
        queries = torch.from_numpy(
            rng.integers(0, 1 << 32, size=(q, server.num_query_cols), dtype=np.uint32).view(np.int32)).to(dev)
        digit_fn = lambda: respond_ops.respond_batch(queries, planes.d0, planes.d1)  # noqa: E731
        packed_fn = lambda: rp.respond_batch_packed(queries, packed.planes)  # noqa: E731
        if not torch.equal(digit_fn()[:, : planes.num_cols], packed_fn()):
            raise AssertionError(f"digit2 and packed respond differ at Q={q}")
        times = cuda_ms(packed_fn, 10), cuda_ms(digit_fn, 5), cuda_ms(digit_fn, 5), cuda_ms(packed_fn, 10)
        log(f"  respond Q={q} at 2^20, CUDA-event medians, {smi}: packed kernel ({regime(q, packed.mat_elem_bit_len)}) "
            f"{times[0]:.3f}, {times[3]:.3f} ms; digit2 (torch._int_mm, {-(-planes.d0.shape[0] // (1 << 16))} "
            f"K pieces x 2 planes) {times[1]:.3f}, {times[2]:.3f} ms")
    del db20, server, planes, packed, interop, queries, digit_fn, packed_fn
    torch.cuda.empty_cache()
    phase_done("phase 12b")

    # -- phase 13: the JAX package's call surface on the card ------------------
    from chalametpir_tpu_torch import BinaryFuseFilter

    n = SURFACE_ENTRIES
    db = build_db(n, VALUE_LEN, args.seed + 4)
    pir_seed = rng.bytes(32)
    keys = list(db)
    probe = [keys[int(i)] for i in rng.choice(n, size=8, replace=False)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    # Server.setup in the JAX package's positional order, beside the keyword call
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(pir_seed, db, 3, "auto", "packed", "ctr",
                                         rng=np.random.default_rng(args.seed))
    setup_s = time.perf_counter() - t0
    kw_server, kw_hint, kw_fparams = Server.setup(pir_seed, db, arity=3, backend="auto", layout="packed",
                                                  prg_mode="ctr", rng=np.random.default_rng(args.seed), device=dev)
    if (hint, fparams) != (kw_hint, kw_fparams):
        raise AssertionError("Server.setup's positional and keyword calls give different hint or filter bytes")
    if (server.backend, server.layout, server.device.type) != ("torch", "packed", dev.type):
        raise AssertionError(f"the positional setup built {server.backend}/{server.layout} on {server.device}")
    m = server.num_query_cols
    qmat = rng.integers(0, 1 << 32, size=(64, m), dtype=np.uint32)
    if not np.array_equal(server.respond_batch(qmat), kw_server.respond_batch(qmat)):
        raise AssertionError("the positional and keyword servers' respond_batch differ")
    if any(not np.array_equal(server.respond_batch(qmat[i : i + 1]), kw_server.respond_batch(qmat[i : i + 1]))
           for i in range(16)):
        raise AssertionError("the positional and keyword servers' single responses differ")
    del kw_server
    log(f"  {n} entries x {VALUE_LEN} B, arity 3, ctr: Server.setup(seed, db, 3, \"auto\", \"packed\", \"ctr\") "
        f"in {setup_s:.2f} s, m={m} b={server.mat_elem_bit_len}: hint, filter, 16 single and 64 batched "
        f"responses equal to the keyword call's")
    # A on the host, by the port's ctr expansion, for two engines and the host client
    t0 = time.perf_counter()
    a_host = prg.expand_seed(LWE_DIMENSION, m, pir_seed, mode="ctr")
    log(f"  host ctr expansion of A ({a_host.nbytes} B) {time.perf_counter() - t0:.2f} s")

    def km_engine():
        """"km" planes (4, k, m) as the JAX engine's from_host_matrix
        builds them, made on the card, then the JAX constructor."""
        a_dev = torch.from_numpy(a_host.view(np.int32)).to(dev)
        planes_km = torch.stack([(((a_dev >> (8 * j)) & 255) - 128).to(torch.int8) for j in range(4)])
        del a_dev
        return DeviceQueryEngine(planes_km, LWE_DIMENSION, m, "km")

    constructors = {
        "from_seed_ctr(seed, m, 32768)": lambda: DeviceQueryEngine.from_seed_ctr(pir_seed, m, 32768),
        "from_host_matrix(A)": lambda: DeviceQueryEngine.from_host_matrix(a_host),
        "DeviceQueryEngine(planes, k, m, \"km\")": km_engine,
        "streaming_from_seed_ctr(seed, m)": lambda: DeviceQueryEngine.streaming_from_seed_ctr(pir_seed, m),
    }
    codes = {q: rng.integers(0, 3, size=(q, LWE_DIMENSION)).astype(np.int8) for q in (1, 64)}
    want = {}
    for name, build in constructors.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if eng.device.type != dev.type:
            raise AssertionError(f"{name} is not on the card")
        times = []
        for q, c in codes.items():
            got = eng.matvec_batch(c)
            if not np.array_equal(got, want.setdefault(q, got)):
                raise AssertionError(f"{name}: s.A at Q={q} differs from {next(iter(constructors))}")
            times.append(cuda_ms(lambda: eng.matvec_batch_async(c), 5))
        log(f"  {name}: built in {build_s:.2f} s, layout {eng.layout}, {eng.device_bytes} B on the card; "
            f"s.A equal at Q=1 and 64, CUDA-event median {times[0]:.3f} ms (Q=1), {times[1]:.3f} ms (Q=64); {smi}")
        del eng
        torch.cuda.empty_cache()
    if not np.array_equal(want[1][0], engine.ternary_matvec(codes[1][0], a_host)):
        raise AssertionError("the engines' s.A differs from the native host matvec over the host A")
    # the JAX client's host engine: s.A by the native matvec over the host A
    client = Client(a_host, matrix_io.matrix_from_bytes(hint), BinaryFuseFilter.from_bytes(fparams),
                    seed=pir_seed, prg_mode="ctr")
    if client.uses_device:
        raise AssertionError("a client built from pub_mat_a runs on a device engine")
    query_ms = []
    for key in probe[:4]:
        t0 = time.perf_counter()
        qb = query(client, key)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        if client.process_response(key, server.respond(qb)) != db[key]:
            raise AssertionError("the host client decoded a wrong value")
    client.prepare_queries(4)
    if "host_matvec_s" not in client.prepare_stats:
        raise AssertionError(f"the host client's prepare_stats lack host_matvec_s: {client.prepare_stats}")
    for key, qb in zip(probe[4:], client.query_batch(probe[4:])):
        if client.process_response(key, server.respond(qb)) != db[key]:
            raise AssertionError("the host client's pooled query decoded a wrong value")
    torch.cuda.synchronize()
    surface_launches = require_launched(("ctr_keccak", "respond_packed_scan", "respond_packed_mma"),
                                        "JAX-surface path")
    for name in ("ctr_keccak", "respond_packed_scan", "respond_packed_mma"):
        launches[name] += surface_launches[name]
    log(f"  Client(pub_mat_a, hint, filt, seed=seed, prg_mode=\"ctr\"): 8 keys round-tripped (4 inline, query() "
        f"wall {', '.join(f'{t:.0f}' for t in query_ms)} ms; 4 from the pool, prepare_stats {client.prepare_stats}); "
        f"launches {surface_launches}")
    del db, server, client, a_host, want
    torch.cuda.empty_cache()
    phase_done("phase 13")

    # -- phase 14: the bench path, bench_torch.py's headline cell --------------
    # its own process, as a user runs it; its launch record is its path's
    bench = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_torch.py"),
         "--cell", BENCH_CELL, "--seed", str(BENCH_SEED)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = bench.communicate(timeout=BENCH_DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(bench.pid, signal.SIGKILL)
        raise AssertionError(f"bench_torch.py timed out:\n{bench.communicate()[1][-3000:]}")
    lines = out.splitlines()
    if bench.returncode != 0 or not lines:
        raise AssertionError(f"bench_torch.py failed (rc {bench.returncode}):\n{err[-3000:]}")
    last = json.loads(lines[-1])
    log(f"phase 14 bench: {lines[-1]}")
    if last["phase"] != "done" or last["correct"] is not True:
        raise AssertionError(f"bench_torch.py --cell {BENCH_CELL}: not correct")
    missing = [name for name in ("ctr_keccak", "respond_packed_scan", "respond_packed_mma")
               if not last["launches"][name]]
    if missing:
        raise AssertionError(f"{', '.join(missing)} never ran on the bench path: {last['launches']}")
    for name in launches:
        launches[name] += last["launches"][name]
    phase_done("phase 14")
    log(f"total {time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errors.max[name],
         "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound[name][0],
         "bound_by": bound[name][1], "library_ms": library_ms[name]}
        for name, (src, rep) in SOURCES.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
