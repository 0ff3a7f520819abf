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

`layout="auto"` packs the planes at every element width, b 13-14 included
(one hi byte per element), where the JAX package's "auto" switches to its
digit2 layout: the hint and the responses are the same integers.
`layout="digit2"` holds D as two int8 digit planes and multiplies them with
`torch._int_mm` (ops/matmul_u32.py, ops/respond.py), as the JAX package's
digit2 path does with `lax.dot_general`: no hand-written kernel, and much
slower on a CUDA card than the packed kernel. `backend="numpy"` is the
oracle the tests cross-check against: D as uint16 on the host, every
product a uint64 numpy matmul, no torch tensor anywhere.

`device` is explicit: "cuda" runs the kernels and raises AcceleratorError
when there is no CUDA device; "cpu" runs the plain torch versions (the
test path).
"""

from __future__ import annotations

import ast
import contextlib
import gc
import time

import numpy as np
import torch

from ..core import encode_db, matrix_io, prg
from ..core.filter import filter_geometry
from ..errors import (
    AcceleratorError,
    EmptyKVDatabase,
    ImpossibleEncodedDBMatrixElementBitLength,
    IncompatibleDimensionForRowVectorTransposedMatrixMultiplication,
)
from ..native import engine
from ..ops import matmul_u32, prg_torch
from ..ops import respond as respond_ops
from ..ops.respond_packed import (
    LANE,
    M_ALIGN,
    PackedPlanes,
    build_packed_db,
    hint_fold_partial,
    pack_geometry,
    respond_batch_packed,
    respond_packed_core,
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


def resolve_device(device) -> torch.device:
    """torch.device for a device request. "cpu" and "cuda" (or any torch
    device of those types) are taken as they are; the JAX client's values
    are accepted too: False is the CPU, True is CUDA, "auto" is CUDA when
    there is a CUDA device and the CPU otherwise. The choice is made here,
    once, before any work: a CUDA request on a machine without CUDA raises
    instead of running on the CPU, and nothing that fails later falls back.
    Client.setup takes False, and "auto" without CUDA, as the JAX client's
    host engine before it calls this."""
    if device is False:
        device = "cpu"
    elif device is True:
        device = "cuda"
    elif isinstance(device, str) and device == "auto":
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise AcceleratorError(f"device {device} requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device} (cpu or cuda)")
    return device


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


class _CpuClock:
    """Wall, this thread's CPU and the process's CPU since construction, for
    the `cpu_s` entry of setup_stats: measured with perf_counter,
    thread_time and process_time, never modeled."""

    def __init__(self):
        self.t0 = time.perf_counter(), time.thread_time(), time.process_time()

    def attrib(self, **other: float) -> dict:
        """{wall, main, <other thread>, runtime, external}: `other` names
        one helper thread's measured CPU seconds (the encode worker, the
        XOF producer); runtime is every further thread of the process;
        external is wall during which the process held no core."""
        wall, main, proc = (now - then for now, then in zip(
            (time.perf_counter(), time.thread_time(), time.process_time()), self.t0))
        helper = sum(other.values())
        return {
            "wall": round(wall, 2),
            "main": round(main, 2),
            **{k: round(v, 2) for k, v in other.items()},
            "runtime": round(max(proc - main - helper, 0.0), 2),
            "external": round(max(wall - proc, 0.0), 2),
        }


class Server:
    """Stateful PIR server holding the encoded database: packed planes or
    digit planes on a torch device, or D itself on the host (the numpy
    oracle)."""

    def __init__(self, backend: str, planes, num_query_cols: int, num_response_cols: int,
                 mat_elem_bit_len: int, layout: str = "digit2", mesh=None):
        """The JAX package's constructor, in its order: `backend` "torch"
        or "numpy" (also "auto", which is "torch"; "jax" raises ValueError);
        `planes` as `planes` returns them for that backend and layout."""
        # torch/packed: PackedPlanes on one device, or parallel.ShardedPlanes
        # over `mesh`; torch/digit2: ops.respond.DigitPlanes; numpy: the raw
        # uint16 D matrix
        if layout not in ("packed", "digit2"):
            raise ValueError(f"unknown layout {layout!r} (packed/digit2)")
        self._planes = planes
        self._backend = _resolve_backend(backend)
        self._layout = layout
        self._num_query_cols = num_query_cols
        self._num_response_cols = num_response_cols
        self.mat_elem_bit_len = mat_elem_bit_len
        # measured setup attribution, filled by setup()
        self.setup_stats: dict = {}
        self._mesh = mesh
        self._sharded_respond = None
        if mesh is not None:
            from ..parallel import sharded_respond_packed_fn

            self._sharded_respond = sharded_respond_packed_fn(mesh, planes)

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
            elif layout == "digit2":
                server, hint, filt = cls._setup_digit2(seed, db, arity, bit_len, rng, device, prg_mode,
                                                       hint_block_rows)
            elif prg_mode == "ctr":
                server, hint, filt = cls._setup_ctr_pipelined(seed, db, arity, bit_len, rng, device)
            else:
                server, hint, filt = cls._setup_stream(seed, db, arity, bit_len, rng, device,
                                                       hint_block_rows or STREAM_BLOCK_ROWS)
        return server, matrix_io.matrix_to_bytes(hint), filt.to_bytes()

    @classmethod
    def _setup_numpy(cls, seed, db, arity, bit_len, rng, prg_mode):
        """The oracle: the whole of A on the host and one uint64 matmul,
        exact mod 2^32 by wrap-around. Nothing here touches torch."""
        with telemetry.span("server_setup.encode_db", entries=len(db), b=bit_len):
            mat_d, filt = encode_db.from_kv_database(
                db, arity, bit_len, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng
            )
        m, cols = mat_d.shape
        mat_a = prg.expand_seed(LWE_DIMENSION, m, seed, mode=prg_mode)
        hint = (mat_a.astype(np.uint64) @ mat_d.astype(np.uint64)).astype(np.uint32)
        # layout "digit2": what the JAX package's numpy server reports and
        # writes into its archives, though D is held unpacked
        return cls("numpy", mat_d, m, cols, bit_len, "digit2"), hint, filt

    @classmethod
    def _setup_digit2(cls, seed, db, arity, bit_len, rng, device, prg_mode, hint_block_rows):
        """digit2 setup, the JAX package's: encode D on the host, recode it
        into two balanced int8 digit planes on the device, then fold A into
        the hint a block of rows at a time, each block's four digits
        against both planes (ops/matmul_u32.py). A's row blocks come off
        the host in both PRG modes, a block ahead in a thread: the serial
        XOF in stream mode; in ctr mode the whole of A expanded on the host
        first, since a row block is strided in the fingerprint-major ctr
        stream."""
        clock = _CpuClock()
        wall0 = time.perf_counter()
        with telemetry.span("server_setup.encode_db", entries=len(db), b=bit_len):
            mat_d, filt = encode_db.from_kv_database(
                db, arity, bit_len, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng
            )
        m, cols = mat_d.shape
        phase = dict(encode=time.perf_counter() - wall0, planes_upload=0.0, wait=0.0, put=0.0,
                     dispatch=0.0, drain=0.0)
        t0 = time.perf_counter()
        with telemetry.span("server_setup.digit_planes_upload", m=m, cols=cols):
            planes = respond_ops.build_digit_planes(mat_d, bit_len, device)
        del mat_d
        phase["planes_upload"] = time.perf_counter() - t0

        block_rows = min(hint_block_rows or _digit2_block_rows(m), LWE_DIMENSION)
        hint = torch.zeros((LWE_DIMENSION, planes.d0.shape[1]), dtype=torch.int32, device=device)
        xof: dict = {}
        a_bytes = 0
        with telemetry.span("server_setup.hint_digit2", blocks=-(-LWE_DIMENSION // block_rows)), \
                contextlib.closing(prg.prefetch_iter(
                    prg.iter_row_blocks(LWE_DIMENSION, m, seed, block_rows, mode=prg_mode), stats=xof
                )) as blocks:
            while True:
                t0 = time.perf_counter()
                item = next(blocks, None)
                phase["wait"] += time.perf_counter() - t0
                if item is None:
                    break
                r0, block = item
                t0 = time.perf_counter()
                a = torch.from_numpy(np.ascontiguousarray(block).view(np.int32)).to(device)
                a_bytes += block.nbytes
                phase["put"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                rows = slice(r0, r0 + block.shape[0])
                hint[rows] = matmul_u32.digit_matmul_accumulate(hint[rows], a, planes.d0, planes.d1)
                phase["dispatch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            hint_host = hint[:, :cols].cpu().numpy().view(np.uint32)
            phase["drain"] = time.perf_counter() - t0

        server = cls("torch", planes, m, cols, bit_len, "digit2")
        server.setup_stats = {
            "upload_bytes": a_bytes + planes.device_bytes,
            "a_upload_bytes": a_bytes,
            "upload_s": round(phase["planes_upload"] + phase["put"] + phase["drain"], 3),
            "xof_cpu_s": round(xof.get("producer_cpu_s", 0.0), 2),
            "hint_block_rows": block_rows,
            "phases_s": {k: round(v, 2) for k, v in phase.items()},
            "cpu_s": clock.attrib(producer=xof.get("producer_cpu_s", 0.0)),
            "wall_s": round(time.perf_counter() - wall0, 2),
        }
        return server, hint_host, filt

    @classmethod
    def _setup_sharded(cls, seed, db, arity, bit_len, rng, prg_mode, mesh):
        """Setup over a mesh: the encode of `_setup_stream` (so the same rng
        gives the same filter as without a mesh), the packed planes
        row-sharded over `model`, then the hint. In ctr mode every shard
        generates only its own fingerprint range of A on its device and
        folds it there. In stream mode A's row blocks come off the host
        XOF, a block ahead in a thread, each zero-padded to the planes'
        padded rows and folded as one batch of queries whose columns are
        split over the shards."""
        from ..parallel import build_sharded_pallas_db, sharded_hint_ctr_packed, sharded_hint_packed_fn

        clock = _CpuClock()
        wall0 = time.perf_counter()
        with telemetry.span("server_setup.encode_db", entries=len(db), b=bit_len):
            mat_d, filt = encode_db.from_kv_database(
                db, arity, bit_len, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng
            )
        m, cols = mat_d.shape
        phase = dict(encode=time.perf_counter() - wall0)
        t0 = time.perf_counter()
        with telemetry.span("server_setup.pack_and_shard", m=m, cols=cols):
            planes = build_sharded_pallas_db(mesh, mat_d, bit_len)
        del mat_d
        phase["pack_shard"] = time.perf_counter() - t0
        m_pad = planes.m_pad

        t0 = time.perf_counter()
        xof: dict = {}
        a_bytes = 0
        if prg_mode == "ctr":
            with telemetry.span("server_setup.hint_sharded_ctr", m_pad=m_pad):
                hint = sharded_hint_ctr_packed(mesh, planes, seed)
        else:
            hint_step = sharded_hint_packed_fn(mesh, planes)
            block_rows = min(max(1, (16 << 20) // (4 * m)), LWE_DIMENSION)
            parts = []
            with telemetry.span("server_setup.hint_sharded", m_pad=m_pad), \
                    contextlib.closing(prg.prefetch_iter(
                        prg.iter_row_blocks(LWE_DIMENSION, m, seed, block_rows, mode=prg_mode), stats=xof
                    )) as blocks:
                for _, block in blocks:
                    a = torch.zeros((block.shape[0], m_pad), dtype=torch.int32)
                    a[:, :m] = torch.from_numpy(block.view(np.int32))
                    a_bytes += block.nbytes
                    parts.append(hint_step(a))
                hint = torch.cat([p.cpu() for p in parts]).contiguous().numpy().view(np.uint32)
        phase["hint"] = time.perf_counter() - t0

        server = cls("torch", planes, m, cols, bit_len, "packed", mesh=mesh)
        server.setup_stats = {
            # the planes this process placed on its devices, and in stream
            # mode A's row blocks, which go to the devices inside the hint
            # steps; upload_s is the pack-and-place phase alone
            "upload_bytes": planes.device_bytes + a_bytes,
            "a_upload_bytes": a_bytes,
            "upload_s": round(phase["pack_shard"], 3),
            "phases_s": {k: round(v, 2) for k, v in phase.items()},
            "cpu_s": clock.attrib(producer=xof.get("producer_cpu_s", 0.0)),
            "wall_s": round(time.perf_counter() - wall0, 2),
        }
        return server, hint, filt

    @classmethod
    def _setup_stream(cls, seed, db, arity, bit_len, rng, device, block_rows=STREAM_BLOCK_ROWS):
        """Stream-mode setup: encode D on the host (the JAX package's
        encode, so the same rng gives the same filter), upload its packed
        planes, then fold A into the hint `block_rows` rows at a time:
        hint[r0:r0+r] += A[r0:r0+r] . D, with the rows of A as the query
        batch of the respond kernel. A comes from the host XOF, one serial
        sponge read in row order, which a thread runs ahead of the folds
        (the native squeeze releases the GIL); each block is copied to the
        device from pageable memory, a copy that returns once its source
        has been read, so the producer's next block never races it."""
        clock = _CpuClock()
        wall0 = time.perf_counter()
        with telemetry.span("server_setup.encode_db", entries=len(db), b=bit_len):
            mat_d, filt = encode_db.from_kv_database(
                db, arity, bit_len, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng
            )
        m, cols = mat_d.shape
        phase = dict(encode=time.perf_counter() - wall0, pack_upload=0.0, wait=0.0, put=0.0,
                     dispatch=0.0, drain=0.0)
        t0 = time.perf_counter()
        with telemetry.span("server_setup.pack_and_upload", m=m, cols=cols):
            planes = build_packed_db(mat_d, bit_len, device)
        del mat_d
        phase["pack_upload"] = time.perf_counter() - t0

        r = min(block_rows, LWE_DIMENSION)
        hint = torch.zeros((LWE_DIMENSION, planes.lo.shape[1]), dtype=torch.int32, device=device)
        xof: dict = {}
        a_bytes = 0
        with telemetry.span("server_setup.hint_stream", blocks=-(-LWE_DIMENSION // r)), \
                contextlib.closing(prg.prefetch_iter(
                    prg.iter_row_blocks(LWE_DIMENSION, m, seed, r, mode="stream"), stats=xof
                )) as blocks:
            while True:
                t0 = time.perf_counter()
                item = next(blocks, None)
                phase["wait"] += time.perf_counter() - t0
                if item is None:
                    break
                r0, block = item
                t0 = time.perf_counter()
                a = torch.from_numpy(block.view(np.int32)).to(device)
                a_bytes += block.nbytes
                phase["put"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                respond_packed_core(a, planes.lo, planes.hi, bit_len, cols,
                                    out=hint[r0 : r0 + block.shape[0]])
                phase["dispatch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            hint_host = hint[:, :cols].cpu().numpy().view(np.uint32)
            phase["drain"] = time.perf_counter() - t0

        server = cls("torch", planes, m, cols, bit_len, "packed")
        server.setup_stats = {
            "upload_bytes": a_bytes + planes.device_bytes,
            "a_upload_bytes": a_bytes,
            "upload_s": round(phase["pack_upload"] + phase["put"] + phase["drain"], 3),
            "xof_cpu_s": round(xof.get("producer_cpu_s", 0.0), 2),
            "phases_s": {k: round(v, 2) for k, v in phase.items()},
            "cpu_s": clock.attrib(producer=xof.get("producer_cpu_s", 0.0)),
            "wall_s": round(time.perf_counter() - wall0, 2),
        }
        return server, hint_host, filt

    @classmethod
    def _setup_ctr_pipelined(cls, seed, db, arity, bit_len, rng, device):
        """Streaming setup: as each fingerprint-row chunk of D finishes
        encoding it is packed on the host, copied into the device planes,
        and folded into the hint against A's chunk slab generated on the
        device."""
        clock = _CpuClock()
        wall0 = time.perf_counter()
        # filter geometry is a function of the DB size alone, so the chunk
        # size is known before the filter is built
        _, _, num_fp = filter_geometry(arity, len(db))
        cc = _ctr_chunk_cols(num_fp, M_ALIGN)
        worker_stats: dict = {}
        with telemetry.span("server_setup.encode_stream", entries=len(db), b=bit_len, chunk=cc):
            mat16, filt, chunks = encode_db.from_kv_database_streaming(
                db, arity, bit_len, cc, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng, stats=worker_stats
            )
        m = filt.num_fingerprints
        m_pad, cols = mat16.shape
        c_pad = -(-cols // LANE) * LANE
        pack, bits, pc = pack_geometry(bit_len, c_pad)

        # -128 biased == value zero wherever no chunk writes
        lo = torch.full((m_pad, c_pad), -128, dtype=torch.int8, device=device)
        hi = torch.zeros((m_pad, pc), dtype=torch.uint8, device=device) if pack else None
        hint = torch.zeros((LWE_DIMENSION, c_pad), dtype=torch.int32, device=device)
        seed_words = prg_torch.seed_to_words(seed)

        phase = dict(wait=0.0, pack=0.0, pack_cpu=0.0, put=0.0, dispatch=0.0, drain=0.0)
        upload_bytes = 0
        # one host pack-buffer pair, reused: a copy from pageable host memory
        # returns only once the source has been read (it also waits for the
        # device work queued before it, so `put` includes that wait)
        pack_bufs = None
        it = iter(chunks)
        with telemetry.span("server_setup.stream_pack_upload_fold", chunks=m_pad // cc, m=m, cols=cols):
            while True:
                t0 = time.perf_counter()
                j = next(it, None)
                phase["wait"] += time.perf_counter() - t0
                if j is None:
                    break
                r0 = j * cc
                t0, c0 = time.perf_counter(), time.thread_time()
                pack_bufs = lo_host, hi_host = engine.build_packed_planes(
                    mat16[r0 : r0 + cc], cc, c_pad, pack, bits, tight_lo=True, out=pack_bufs
                )
                phase["pack"] += time.perf_counter() - t0
                phase["pack_cpu"] += time.thread_time() - c0

                t0 = time.perf_counter()
                # tight lo (cc, cols): the zero columns never cross the link;
                # the device planes' padding columns already hold -128
                lo[r0 : r0 + cc, :cols].copy_(torch.from_numpy(lo_host))
                upload_bytes += lo_host.nbytes
                if pack:
                    hi[r0 : r0 + cc].copy_(torch.from_numpy(hi_host))
                    upload_bytes += hi_host.nbytes
                phase["put"] += time.perf_counter() - t0

                t0 = time.perf_counter()
                slab = prg_torch.expand_fp_slab(seed_words, r0, cc, LWE_DIMENSION, device)
                hint_fold_partial(
                    slab.t(), lo[r0 : r0 + cc], hi[r0 : r0 + cc] if pack else None, bit_len, cols,
                    out=hint,
                )
                phase["dispatch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            hint_host = hint[:, :cols].cpu().numpy().view(np.uint32)
            phase["drain"] = time.perf_counter() - t0
        telemetry.trace_event("stream_pipeline_phases", **{k: round(v, 2) for k, v in phase.items()})

        server = cls("torch", PackedPlanes(lo, hi, bit_len, m, cols), m, cols, bit_len, "packed")
        server.setup_stats = {
            "upload_bytes": upload_bytes,
            "upload_s": round(phase["put"] + phase["drain"], 3),
            "phases_s": {k: round(v, 2) for k, v in phase.items()},
            # wall = main (this thread: pack, copies, waits) + worker (the
            # native encode thread, which has ended: the chunk iterator
            # joins it) + runtime (every other thread) + external
            "cpu_s": clock.attrib(worker=worker_stats.get("worker_cpu_s", 0.0)),
            "worker_minflt": worker_stats.get("worker_minflt"),
            "wall_s": round(time.perf_counter() - wall0, 2),
        }
        return server, hint_host, filt

    # -- online --------------------------------------------------------------

    def respond(self, query: bytes) -> bytes:
        """Answer a single serialized client query."""
        q = matrix_io.matrix_from_bytes(query)
        if q.shape[0] != 1 or q.shape[1] != self._num_query_cols:
            raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
        return matrix_io.matrix_to_bytes(self.respond_batch(q))

    def respond_batch(self, queries: np.ndarray) -> np.ndarray:
        """(Q, m) uint32 -> (Q, C) uint32: one kernel launch per batch over
        packed planes, two `torch._int_mm` products per K_SPLIT rows over
        digit planes, a uint64 matmul on the host for the numpy oracle."""
        queries = np.ascontiguousarray(queries, np.uint32)
        if queries.ndim != 2 or queries.shape[1] != self._num_query_cols:
            raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
        if self._backend == "numpy":
            return (
                queries.astype(np.uint64) @ self._planes.astype(np.uint64)
            ).astype(np.uint32)
        if self._sharded_respond is not None:
            # zero columns up to the planes' padded rows, zero rows up to a
            # multiple of the data axis; both are cut from the answer
            nq, data = queries.shape[0], self._mesh.shape["data"]
            q = torch.zeros((-(-nq // data) * data, self._planes.m_pad), dtype=torch.int32)
            q[:nq, : queries.shape[1]] = torch.from_numpy(queries.view(np.int32))
            return self._sharded_respond(q)[:nq].cpu().contiguous().numpy().view(np.uint32)
        # the explicit device (never the calling thread's current one): the
        # TCP dispatcher calls this from a worker thread
        q = torch.from_numpy(queries.view(np.int32)).to(self.device)
        if self._layout == "digit2":
            p = self._planes
            out = respond_ops.respond_batch(q, p.d0, p.d1)[:, : p.num_cols].contiguous()
        else:
            out = respond_batch_packed(q, self._planes)
        return out.cpu().numpy().view(np.uint32)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the serving state in the JAX package's archive layouts
        (chalametpir_tpu.Server.save), which either package's `load`
        reads: a `meta` repr and, for packed planes, `lo`, `hi` and
        `tile_k`, the row alignment of the planes; for digit planes `d0`
        and `d1` cut to (m, c), under backend "jax"; for the numpy oracle
        `mat_d`. The hint and filter params are not in it: they left at
        setup.

        A server sharded over an in-process mesh gathers its shards, as
        the JAX package does: the archive loads as an unsharded server (the
        TCP server's main refuses --save-state with --mesh for that
        reason). A rank of a multi-process mesh holds one shard and raises
        ValueError."""
        p = self._planes
        meta = dict(
            # the name under which the JAX package's load rebuilds a device server
            backend="numpy" if self._backend == "numpy" else "jax",
            layout=self._layout,
            num_query_cols=self._num_query_cols,
            num_response_cols=self._num_response_cols,
            mat_elem_bit_len=self.mat_elem_bit_len,
        )
        if self._backend == "numpy":
            arrays = dict(mat_d=p)
        elif self._layout == "digit2":
            m, c = p.num_rows, p.num_cols
            arrays = dict(d0=p.d0[:m, :c].cpu().numpy(), d1=p.d1[:m, :c].cpu().numpy())
        else:
            lo, hi = p.gather() if self._mesh is not None else (p.lo, p.hi)
            arrays = dict(lo=lo.cpu().numpy(), tile_k=np.array([M_ALIGN]))
            if hi is not None:
                arrays["hi"] = hi.cpu().numpy()
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
            device = resolve_device(device)
            if meta["layout"] == "packed":
                lo = archive["lo"]
                if lo.ndim != 2 or lo.shape[0] < m or lo.shape[1] < c:
                    raise ValueError(f"archive planes {lo.shape} do not cover {m} x {c}")
                hi = archive["hi"] if "hi" in archive else None
                planes = PackedPlanes(
                    torch.from_numpy(lo).to(device),
                    None if hi is None else torch.from_numpy(hi).to(device),
                    b, m, c,
                )
            elif meta["layout"] == "digit2":
                planes = respond_ops.digit_planes_from_host(archive["d0"], archive["d1"], b, device)
            else:
                raise ValueError(f"unknown archive layout {meta['layout']!r}")
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
        if self._backend == "numpy":
            return torch.device("cpu")
        return self._planes.device

    @property
    def num_query_cols(self) -> int:
        return self._num_query_cols

    @property
    def num_response_cols(self) -> int:
        return self._num_response_cols
