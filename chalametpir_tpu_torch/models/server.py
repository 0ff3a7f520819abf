"""The PIR server on a torch device: packed DB planes, kernel respond path.

Counterpart of chalametpir_tpu/models/server.py (`_setup_jax_ctr_pipelined`,
`_setup_jax` with its packed and digit2 layouts, the numpy oracle backend,
`_setup_sharded`, `respond`, `respond_batch`, `save`, `load`). The
encode, the filter, the host XOF and the wire formats are the port's own
copies of the JAX package's framework-free modules (core/, native/), byte
for byte the same protocol; the device work is the port's:

* ctr-mode setup streams the encode in fingerprint-row chunks (native
  engine), packs each finished chunk on the host, copies it into the
  device planes, and folds A[:, chunk] . D[chunk] into the hint with A's
  slab generated on the device by the ctr Keccak kernel — A never crosses
  the host link;
* stream-mode setup (the default: the reference's serial XOF, the only
  mode Rust peers speak) encodes D, uploads its planes, and folds A row
  block by row block into the hint with the respond kernel, each block of
  A rows a batch of queries, the XOF running a block ahead in a thread;
* respond runs the packed respond kernel over the planes, one launch for a
  whole batch of queries;
* with a mesh (parallel/sharding.py) the planes are split in row shards,
  each shard generates its own range of A (ctr) or takes its column slice
  of A's row blocks (stream), and a batch costs one launch a shard, the
  shards' int32 partials summed mod 2^32.

Each way of holding D is a serving state (ops/serving.py) that answers,
folds A's rows into the hint and archives itself; the server picks one at
setup (or from an archive's meta at load) and never asks again which one
it holds. `Server.setup` sets out the backends and layouts; `device` is
resolved once (device.py) and never falls back.
"""

from __future__ import annotations

import ast
import contextlib
import gc
import time

import numpy as np
import torch

from .. import parallel
from ..core import encode_db, matrix_io, prg
from ..core.filter import filter_geometry
from ..device import resolve_device
from ..errors import (
    EmptyKVDatabase,
    ImpossibleEncodedDBMatrixElementBitLength,
    IncompatibleDimensionForRowVectorTransposedMatrixMultiplication,
)
from ..native import engine
from ..ops import prg_torch
from ..ops.respond import DigitPlanes, HostPlanes, build_digit_planes
from ..ops.respond_packed import (
    LANE,
    M_ALIGN,
    PackedPlanes,
    build_packed_db,
    hint_fold_partial,
    pack_geometry,
)
from ..params import (
    LWE_DIMENSION,
    MAX_CIPHER_TEXT_BIT_LEN,
    MIN_CIPHER_TEXT_BIT_LEN,
    SEED_BYTE_LEN,
    SERVER_SETUP_MAX_ATTEMPT_COUNT,
    find_mat_elem_bit_len,
)
from ..utils import telemetry

# DB rows per ctr hint fold chunk, about (see _ctr_chunk_cols)
_CTR_CHUNK_COLS = 1 << 17
# A rows per stream-mode hint fold: one 16-query tile of the respond
# kernel, which scans the planes once per tile whatever the block size —
# so 111 launches at any m, and a 16 x m x 4-byte block (75 MB at 2^20
# entries) for the XOF to fill before the first fold starts
STREAM_BLOCK_ROWS = 16
# u32 bytes of A per digit2 hint fold, about (see _digit2_block_rows)
DIGIT2_BLOCK_BYTES = 1 << 30
# the JAX package's hint buffer height: LWE rows rounded up to its 128-row
# fold groups. Its padded rows are zero and cut off; the port folds all
# LWE_DIMENSION rows in one launch and pads none, so only callers read it
K_PAD = -(-LWE_DIMENSION // 128) * 128  # 1792
# the serving state a device archive's layout rebuilds (Server.load)
_ARCHIVED_LAYOUTS = {"packed": PackedPlanes, "digit2": DigitPlanes}


def _ctr_chunk_cols(m: int, tile_k: int) -> int:
    """DB-row chunk size for the ctr hint folds and the streaming upload:
    ~2^17 rows, whole tiles, chunks sized EVENLY over m. A fixed 2^17
    chunk would round m up to whole chunks (at 2^18/arity-3 geometry, 25 %
    padding through the host link); dividing m evenly keeps the overhang
    under one tile per chunk. The JAX server's rule, so both packages cut
    the same chunks."""
    n_chunks = max(1, -(-m // _CTR_CHUNK_COLS))
    per_chunk = -(-m // n_chunks)
    return -(-per_chunk // tile_k) * tile_k


@contextlib.contextmanager
def _gc_paused():
    """No cyclic garbage collection inside the block: setup allocates
    millions of small objects (keys, values) that a collection pass would
    walk again and again."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def _resolve_backend(backend: str) -> str:
    """"torch" or "numpy". "auto" is torch. The JAX package's "jax" names a
    backend this package does not have: ValueError, as for any unknown
    name, with the name to use instead."""
    if backend == "auto":
        return "torch"
    if backend == "jax":
        raise ValueError("unknown backend 'jax': this package's device backend is \"torch\"")
    if backend not in ("torch", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _digit2_block_rows(m: int) -> int:
    """Rows of A per digit2 hint fold when the caller names none: a block
    of about DIGIT2_BLOCK_BYTES of u32 words, at least 8 rows (32 digit
    rows, the fewest `torch._int_mm` takes on CUDA, so a smaller block pays
    for 32 all the same)."""
    return min(max(8, DIGIT2_BLOCK_BYTES // (4 * m)), LWE_DIMENSION)


# Server._setup_host_rows by layout: (planes builder, its span, its phases_s
# key, the fold's span, rows of A a fold when the caller names none, from m)
_HOST_ROW_LAYOUTS = {
    "packed": (build_packed_db, "server_setup.pack_and_upload", "pack_upload", "server_setup.hint_stream",
               lambda m: STREAM_BLOCK_ROWS),
    "digit2": (build_digit_planes, "server_setup.digit_planes_upload", "planes_upload", "server_setup.hint_digit2",
               _digit2_block_rows),
}


class _CpuClock:
    """Wall, this thread's CPU and the process's CPU since construction:
    measured with perf_counter, thread_time and process_time, never modeled."""

    def __init__(self):
        self.t0 = time.perf_counter(), time.thread_time(), time.process_time()

    def setup_stats(self, phase: dict, upload_s: float, helper: dict, **counts) -> dict:
        """A route's setup_stats: `counts`, `upload_s`, the `phase` seconds
        and `cpu_s` = {wall, main, <helper>, runtime, external}: `helper`
        names one helper thread's measured CPU seconds (the encode worker,
        the XOF producer); runtime is every further thread of the process;
        external is wall during which the process held no core."""
        wall, main, proc = (now - then for now, then in zip(
            (time.perf_counter(), time.thread_time(), time.process_time()), self.t0))
        cpu = {
            "wall": round(wall, 2),
            "main": round(main, 2),
            **{k: round(v, 2) for k, v in helper.items()},
            "runtime": round(max(proc - main - sum(helper.values()), 0.0), 2),
            "external": round(max(wall - proc, 0.0), 2),
        }
        return {**counts, "upload_s": round(upload_s, 3), "phases_s": {k: round(v, 2) for k, v in phase.items()},
                "cpu_s": cpu, "wall_s": round(time.perf_counter() - self.t0[0], 2)}


def _encode(db, arity: int, bit_len: int, rng):
    """(D, the filter, seconds) by the JAX package's encode, so the same rng
    gives the same filter."""
    t0 = time.perf_counter()
    with telemetry.span("server_setup.encode_db", entries=len(db), b=bit_len):
        mat_d, filt = encode_db.from_kv_database(db, arity, bit_len, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng)
    return mat_d, filt, time.perf_counter() - t0


def _lap(phase: dict, key: str, t0: float, span: str | None = None) -> float:
    """Add the phase begun at t0 to phase[key] (and record it as `span`); returns its end."""
    t1 = time.perf_counter()
    phase[key] = phase.get(key, 0.0) + t1 - t0
    if span:
        telemetry.add_span(span, t0, t1)
    return t1


def _fold_host_rows(planes, seed: bytes, m: int, block_rows: int, prg_mode: str, phase: dict,
                    span: str, **fields):
    """(the (k, c) uint32 hint A . D on the host, the bytes of A put, the
    producer's stats) from A's host row blocks, which a thread produces a
    block ahead (the native XOF squeeze releases the GIL); a block's copy
    from pageable memory returns once its source has been read, so the
    producer's next block never races it. Adds the phases into `phase`."""
    hint = torch.zeros((LWE_DIMENSION, planes.c_pad), dtype=torch.int32, device=planes.device)
    xof: dict = {}
    a_bytes = 0
    with telemetry.span(span, **fields), contextlib.closing(prg.prefetch_iter(
            prg.iter_row_blocks(LWE_DIMENSION, m, seed, block_rows, mode=prg_mode), stats=xof)) as blocks:
        t = time.perf_counter()
        while (item := next(blocks, None)) is not None:
            t = _lap(phase, "wait", t)
            r0, block = item
            a = torch.from_numpy(np.ascontiguousarray(block).view(np.int32)).to(planes.device)
            a_bytes += block.nbytes
            t = _lap(phase, "put", t)
            planes.fold_rows(a, hint[r0 : r0 + block.shape[0]])
            t = _lap(phase, "dispatch", t)
        t = _lap(phase, "wait", t)
        hint_host = hint[:, : planes.num_cols].cpu().numpy().view(np.uint32)
        _lap(phase, "drain", t)
    return hint_host, a_bytes, xof


class Server:
    """Stateful PIR server holding the encoded database in a serving state
    (ops/serving.py): packed planes or digit planes on a torch device,
    packed planes sharded over a mesh, or D on the host (the numpy oracle)."""

    def __init__(self, backend: str, planes, num_query_cols: int, num_response_cols: int,
                 mat_elem_bit_len: int, layout: str = "digit2", mesh=None):
        """The JAX package's constructor, in its order: `backend` "torch"
        or "numpy" (also "auto", which is "torch"; "jax" raises ValueError);
        `planes` as `planes` returns them for that backend and layout.
        `mesh` is taken for the JAX call surface: sharded planes carry
        their own."""
        if layout not in ("packed", "digit2"):
            raise ValueError(f"unknown layout {layout!r} (packed/digit2)")
        self._planes = planes
        self._backend = _resolve_backend(backend)
        # the numpy oracle's raw D serves through its holder
        self._state = HostPlanes(planes) if self._backend == "numpy" else planes
        self._layout = layout
        self._num_query_cols = num_query_cols
        self._num_response_cols = num_response_cols
        self.mat_elem_bit_len = mat_elem_bit_len
        # measured setup attribution, filled by setup()
        self.setup_stats: dict = {}

    @classmethod
    def setup(
        cls,
        seed: bytes,
        db: dict[bytes, bytes],
        arity: int = 3,
        backend: str = "auto",
        layout: str = "auto",
        prg_mode: str = "stream",
        hint_block_rows: int | None = None,
        rng: np.random.Generator | None = None,
        mesh=None,
        mat_elem_bit_len: int | None = None,
        device="cuda",
    ) -> tuple["Server", bytes, bytes]:
        """Encode `db`, compute the hint M = A . D, return
        (server, hint_bytes, filter_param_bytes) — byte-identical to
        chalametpir_tpu.Server.setup with the same seed, DB, rng and
        prg_mode ("stream", the default, derives A as the reference does;
        "ctr" generates it on the device; clients must use the same), at
        any backend, layout and hint_block_rows. The parameters are the
        JAX package's, in its positional order; `device` comes after them.

        backend: "torch" (also "auto") runs on `device`; "numpy" is the
        host oracle (D as uint16, uint64 matmuls, `device` is not read and
        `Server.device` is the CPU). "jax" raises ValueError.

        layout: "packed" (also "auto", at every element width) serves the
        packed planes with the respond kernel; "digit2" holds two int8
        digit planes and multiplies them with `torch._int_mm`, A's row
        blocks coming off the host in both PRG modes as in the JAX
        package. With a mesh the planes are always packed.

        hint_block_rows: rows of A folded into the hint at a time, for
        layout "digit2" and for "packed" in stream mode (default
        STREAM_BLOCK_ROWS); the ctr packed setup folds per DB row chunk and
        does not read it. The hint is the same bytes at any value. The
        digit2 default differs from the JAX package's (16 MB of A, 3 rows
        at 2^20 entries): every digit2 fold pads its block to 32 digit rows
        for `torch._int_mm`, so a small block wastes the card; the default
        here is about DIGIT2_BLOCK_BYTES of A, at least 8 rows
        (`_digit2_block_rows`).

        mesh: a parallel.Mesh (`parallel.make_mesh`, or
        `parallel.multihost.make_multihost_mesh` across processes). The
        encoded DB's fingerprint rows are sharded over its `model` axis
        (for DBs past one device's memory), query batches over `data`; the
        hint and every response are the same bytes as without a mesh. The
        shards live on the mesh's devices and `device` is not read. Across
        processes every rank calls setup with identical inputs (seed, db,
        arity, rng state) and every rank's respond_batch, called with the
        same queries, returns the full answer."""
        if len(db) == 0:
            raise EmptyKVDatabase()
        if len(seed) != SEED_BYTE_LEN:
            raise ValueError(f"seed must be {SEED_BYTE_LEN} bytes")
        if layout not in ("auto", "packed", "digit2"):
            raise ValueError(f"unknown layout {layout!r} (auto/packed/digit2)")
        # 0-byte values are permanently unretrievable through the row codec
        if any(len(v) == 0 for v in db.values()):
            raise ValueError("0-byte values are not encodable by the row codec")
        backend = _resolve_backend(backend)
        if mat_elem_bit_len is not None and not (
            MIN_CIPHER_TEXT_BIT_LEN <= mat_elem_bit_len <= MAX_CIPHER_TEXT_BIT_LEN
        ):
            raise ImpossibleEncodedDBMatrixElementBitLength()
        # the JAX package meets an unknown mode only inside its PRG, after
        # every argument check; here it is the last check before any work
        if prg_mode not in prg.PRG_MODES:
            raise ValueError(f"unknown prg mode {prg_mode!r}")
        if hint_block_rows is not None and hint_block_rows < 1:
            raise ValueError(f"hint_block_rows must be positive, got {hint_block_rows}")
        # a mesh decides before the backend does, as in the JAX package
        if mesh is None and backend != "numpy":
            device = resolve_device(device)
        with _gc_paused():
            bit_len = (
                mat_elem_bit_len
                if mat_elem_bit_len is not None
                else find_mat_elem_bit_len(len(db))
            )
            if mesh is not None:
                server, hint, filt = cls._setup_sharded(seed, db, arity, bit_len, rng, prg_mode, mesh)
            elif backend == "numpy":
                server, hint, filt = cls._setup_numpy(seed, db, arity, bit_len, rng, prg_mode)
            elif layout != "digit2" and prg_mode == "ctr":
                server, hint, filt = cls._setup_ctr_pipelined(seed, db, arity, bit_len, rng, device)
            else:
                server, hint, filt = cls._setup_host_rows(seed, db, arity, bit_len, rng, device,
                                                          "digit2" if layout == "digit2" else "packed", prg_mode,
                                                          hint_block_rows)
        return server, matrix_io.matrix_to_bytes(hint), filt.to_bytes()

    @classmethod
    def _setup_numpy(cls, seed, db, arity, bit_len, rng, prg_mode):
        """The oracle: the whole of A on the host and one uint64 matmul.
        Nothing here touches torch."""
        mat_d, filt, _ = _encode(db, arity, bit_len, rng)
        m, cols = mat_d.shape
        # layout "digit2": what the JAX package's numpy server reports and
        # writes into its archives, though D is held unpacked
        server = cls("numpy", mat_d, m, cols, bit_len, "digit2")
        # A's rows are queries: the hint is their answer
        return server, server._state.respond(prg.expand_seed(LWE_DIMENSION, m, seed, mode=prg_mode)), filt

    @classmethod
    def _setup_sharded(cls, seed, db, arity, bit_len, rng, prg_mode, mesh):
        """The encode of the unsharded routes (so the same rng gives the same
        filter), the packed planes row-sharded over `model`, then the hint:
        in ctr mode every shard generates its own fingerprint range of A on
        its device and folds it there; in stream mode A's host row blocks
        are folded as query batches whose columns are split over the shards."""
        clock = _CpuClock()
        mat_d, filt, encode_s = _encode(db, arity, bit_len, rng)
        m, cols = mat_d.shape
        phase = dict(encode=encode_s)
        t0 = time.perf_counter()
        with telemetry.span("server_setup.pack_and_shard", m=m, cols=cols):
            planes = parallel.build_sharded_pallas_db(mesh, mat_d, bit_len)
        del mat_d
        t0 = _lap(phase, "pack_shard", t0)
        xof: dict = {}
        a_bytes = 0
        if prg_mode == "ctr":
            with telemetry.span("server_setup.hint_sharded_ctr", m_pad=planes.m_pad):
                hint = parallel.sharded_hint_ctr_packed(mesh, planes, seed)
        else:
            block_rows = min(max(1, (16 << 20) // (4 * m)), LWE_DIMENSION)
            hint, a_bytes, xof = _fold_host_rows(planes, seed, m, block_rows, prg_mode, phase,
                                                 "server_setup.hint_sharded", m_pad=planes.m_pad)
        _lap(phase, "hint", t0)
        server = cls("torch", planes, m, cols, bit_len, "packed", mesh=mesh)
        # the planes this process placed on its devices, and in stream mode
        # A's row blocks; upload_s is the pack-and-place phase alone
        server.setup_stats = clock.setup_stats(
            phase, phase["pack_shard"], dict(producer=xof.get("producer_cpu_s", 0.0)),
            upload_bytes=planes.device_bytes + a_bytes, a_upload_bytes=a_bytes)
        return server, hint, filt

    @classmethod
    def _setup_host_rows(cls, seed, db, arity, bit_len, rng, device, layout, prg_mode, block_rows):
        """Encode D on the host, put its planes of `layout` on the device,
        then fold hint[r0:r0+r] += A[r0:r0+r] . D `block_rows` at a time
        (`_fold_host_rows`): for "packed" (stream mode) a query batch of the
        respond kernel, A from the host XOF's serial sponge; for "digit2",
        the JAX package's, the block's four digits against both digit
        planes, A off the host in both PRG modes (in ctr mode all of A
        expanded first: a row block is strided in the ctr stream)."""
        build, build_span, build_phase, fold_span, default_rows = _HOST_ROW_LAYOUTS[layout]
        clock = _CpuClock()
        mat_d, filt, encode_s = _encode(db, arity, bit_len, rng)
        m, cols = mat_d.shape
        phase = {"encode": encode_s}
        t0 = time.perf_counter()
        with telemetry.span(build_span, m=m, cols=cols):
            planes = build(mat_d, bit_len, device)
        del mat_d
        _lap(phase, build_phase, t0)
        r = min(block_rows or default_rows(m), LWE_DIMENSION)
        hint, a_bytes, xof = _fold_host_rows(planes, seed, m, r, prg_mode, phase, fold_span,
                                             blocks=-(-LWE_DIMENSION // r))
        server = cls("torch", planes, m, cols, bit_len, layout)
        producer = xof.get("producer_cpu_s", 0.0)
        server.setup_stats = clock.setup_stats(
            phase, phase[build_phase] + phase["put"] + phase["drain"], dict(producer=producer),
            upload_bytes=a_bytes + planes.device_bytes, a_upload_bytes=a_bytes, xof_cpu_s=round(producer, 2),
            hint_block_rows=r)
        return server, hint, filt

    @classmethod
    def _setup_ctr_pipelined(cls, seed, db, arity, bit_len, rng, device):
        """Streaming setup: as each fingerprint-row chunk of D finishes
        encoding it is packed on the host, copied into the device planes,
        and folded into the hint against A's chunk slab generated on the
        device."""
        clock = _CpuClock()
        # filter geometry is a function of the DB size alone, so the chunk
        # size is known before the filter is built
        _, _, num_fp = filter_geometry(arity, len(db))
        cc = _ctr_chunk_cols(num_fp, M_ALIGN)
        worker_stats: dict = {}
        t0 = time.perf_counter()
        with telemetry.span("server_setup.encode_stream", entries=len(db), b=bit_len, chunk=cc):
            mat16, filt, chunks = encode_db.from_kv_database_streaming(
                db, arity, bit_len, cc, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng, stats=worker_stats
            )
        encode_s = time.perf_counter() - t0
        m = filt.num_fingerprints
        m_pad, cols = mat16.shape
        c_pad = -(-cols // LANE) * LANE
        pack, bits, pc = pack_geometry(bit_len, c_pad)

        # -128 biased == value zero wherever no chunk writes
        lo = torch.full((m_pad, c_pad), -128, dtype=torch.int8, device=device)
        hi = torch.zeros((m_pad, pc), dtype=torch.uint8, device=device) if pack else None
        hint = torch.zeros((LWE_DIMENSION, c_pad), dtype=torch.int32, device=device)
        seed_words = prg_torch.seed_to_words(seed)

        phase = dict(encode=encode_s, wait=0.0, pack=0.0, pack_cpu=0.0, put=0.0, dispatch=0.0, drain=0.0)
        upload_bytes = 0
        # one host pack-buffer pair, reused: a copy from pageable host memory
        # returns only once the source has been read (it also waits for the
        # device work queued before it, so `put` includes that wait)
        pack_bufs = None
        it = iter(chunks)

        def lap(key: str, name: str, t0: float) -> float:
            return _lap(phase, key, t0, "server_setup.chunk." + name)

        with telemetry.span("server_setup.stream_pack_upload_fold", chunks=m_pad // cc, m=m, cols=cols):
            t = time.perf_counter()
            while True:
                j = next(it, None)
                t = lap("wait", "wait", t)
                if j is None:
                    break
                r0 = j * cc
                c0 = time.thread_time()
                pack_bufs = lo_host, hi_host = engine.build_packed_planes(
                    mat16[r0 : r0 + cc], cc, c_pad, pack, bits, tight_lo=True, out=pack_bufs
                )
                phase["pack_cpu"] += time.thread_time() - c0
                t = lap("pack", "pack", t)

                # tight lo (cc, cols): the zero columns never cross the link;
                # the device planes' padding columns already hold -128
                lo[r0 : r0 + cc, :cols].copy_(torch.from_numpy(lo_host))
                upload_bytes += lo_host.nbytes
                if pack:
                    hi[r0 : r0 + cc].copy_(torch.from_numpy(hi_host))
                    upload_bytes += hi_host.nbytes
                t = lap("put", "put", t)

                slab = prg_torch.expand_fp_slab(seed_words, r0, cc, LWE_DIMENSION, device)
                hint_fold_partial(
                    slab.t(), lo[r0 : r0 + cc], hi[r0 : r0 + cc] if pack else None, bit_len, cols,
                    out=hint,
                )
                t = lap("dispatch", "fold", t)
            t = time.perf_counter()
            hint_host = hint[:, :cols].cpu().numpy().view(np.uint32)
            _lap(phase, "drain", t)
        telemetry.trace_event("stream_pipeline_phases", **{k: round(v, 2) for k, v in phase.items()})

        server = cls("torch", PackedPlanes(lo, hi, bit_len, m, cols), m, cols, bit_len, "packed")
        # wall = main (this thread: pack, copies, waits) + worker (the native
        # encode thread, which has ended: the chunk iterator joins it) +
        # runtime (every other thread) + external
        server.setup_stats = clock.setup_stats(
            phase, phase["put"] + phase["drain"], dict(worker=worker_stats.get("worker_cpu_s", 0.0)),
            upload_bytes=upload_bytes, worker_minflt=worker_stats.get("worker_minflt"))
        return server, hint_host, filt

    # -- online --------------------------------------------------------------

    def respond(self, query: bytes) -> bytes:
        """Answer a single serialized client query."""
        with telemetry.span("server.respond"):
            with telemetry.span("server.respond.parse"):
                q = matrix_io.matrix_from_bytes(query)
                if q.shape[0] != 1 or q.shape[1] != self._num_query_cols:
                    raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
            out = self.respond_batch(q)
            with telemetry.span("server.respond.serialize"):
                return matrix_io.matrix_to_bytes(out)

    def respond_batch(self, queries: np.ndarray) -> np.ndarray:
        """(Q, m) uint32 -> (Q, C) uint32, answered by the serving state."""
        with telemetry.span("server.respond_batch") as call:
            queries = np.ascontiguousarray(queries, np.uint32)
            if queries.ndim != 2 or queries.shape[1] != self._num_query_cols:
                raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
            call.set(queries=queries.shape[0])
            with telemetry.span("server.respond_batch.upload", bytes=queries.nbytes):
                q = self._state.upload(queries)
            with telemetry.span("server.respond_batch.kernel"):
                out = self._state.respond(q)
            with telemetry.span("server.respond_batch.readback") as readback:
                answer = self._state.readback(out)
                readback.set(bytes=answer.nbytes)
            return answer

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the serving state in the JAX package's archive layouts
        (chalametpir_tpu.Server.save), which either package's `load`
        reads: a `meta` repr and the arrays of the state's `archive()`. The
        hint and filter params are not in it: they left at setup. A server
        sharded over an in-process mesh gathers its shards, as the JAX
        package does, so the archive loads unsharded (the TCP server's main
        refuses --save-state with --mesh for that reason); a rank of a
        multi-process mesh holds one shard and raises ValueError."""
        meta = dict(
            backend=self._state.archive_backend,
            layout=self._layout,
            num_query_cols=self._num_query_cols,
            num_response_cols=self._num_response_cols,
            mat_elem_bit_len=self.mat_elem_bit_len,
        )
        arrays = self._state.archive()
        # through a file handle: np.savez(str) appends ".npz" to a path
        # without a suffix, which load would then not find
        with open(path, "wb") as f:
            np.savez(f, meta=np.array([repr(meta)]), **arrays)

    @classmethod
    def load(cls, path: str, device="cuda") -> "Server":
        """Rebuild a serving-ready Server from an archive that either
        package's `save` wrote, with the backend and the layout the archive
        names, as the JAX package's `load` does: packed planes and digit
        planes (`d0`, `d1`) go to `device` as they are; a numpy archive
        (`mat_d`) gives the host oracle again, and `device` is not read."""
        with np.load(path) as archive:
            meta = ast.literal_eval(str(archive["meta"][0]))
            b, m, c = meta["mat_elem_bit_len"], meta["num_query_cols"], meta["num_response_cols"]
            if meta["backend"] == "numpy":
                return cls("numpy", archive["mat_d"], m, c, b, meta["layout"])
            kind = _ARCHIVED_LAYOUTS.get(meta["layout"])
            if kind is None:
                raise ValueError(f"unknown archive layout {meta['layout']!r}")
            planes = kind.from_archive(archive, b, m, c, resolve_device(device))
        return cls("torch", planes, m, c, b, meta["layout"])

    @property
    def planes(self):
        """PackedPlanes; parallel.ShardedPlanes on a sharded server;
        ops.respond.DigitPlanes with the digit2 layout; the uint16 D matrix
        itself on the numpy backend."""
        return self._planes

    @property
    def backend(self) -> str:
        """"torch" or "numpy"."""
        return self._backend

    @property
    def layout(self) -> str:
        """"packed" or "digit2" (the numpy backend holds D unpacked and
        reports "digit2", as the JAX package's does)."""
        return self._layout

    @property
    def device(self) -> torch.device:
        """Where respond runs: the planes' device; the CPU for the numpy backend."""
        return self._state.device

    @property
    def num_query_cols(self) -> int:
        return self._num_query_cols

    @property
    def num_response_cols(self) -> int:
        return self._num_response_cols
