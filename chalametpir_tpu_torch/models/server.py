"""The PIR server on a torch device: packed DB planes, kernel respond path.

Counterpart of chalametpir_tpu/models/server.py for its packed layout
(`_setup_jax_ctr_pipelined`, the stream branch of `_setup_jax`, `respond`,
`respond_batch`, `save`, `load`). The encode, the filter, the host XOF and
the wire formats are the JAX package's own framework-free modules,
imported; only the device work is ported:

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
  whole batch of queries.

The planes are packed at every element width, b 13-14 included (one hi
byte per element), where the JAX package's stream path switches to its
digit2 layout: the hint and the responses are the same integers.

`device` is explicit: "cuda" runs the kernels and raises AcceleratorError
when there is no CUDA device; "cpu" runs the plain torch versions (the
test path).
"""

from __future__ import annotations

import ast
import contextlib
import time

import numpy as np
import torch

from chalametpir_tpu.core import encode_db, matrix_io, prg
from chalametpir_tpu.core.filter import filter_geometry
from chalametpir_tpu.errors import (
    AcceleratorError,
    EmptyKVDatabase,
    ImpossibleEncodedDBMatrixElementBitLength,
    IncompatibleDimensionForRowVectorTransposedMatrixMultiplication,
)
from chalametpir_tpu.models.server import _ctr_chunk_cols, _gc_paused
from chalametpir_tpu.params import (
    LWE_DIMENSION,
    MAX_CIPHER_TEXT_BIT_LEN,
    MIN_CIPHER_TEXT_BIT_LEN,
    SEED_BYTE_LEN,
    SERVER_SETUP_MAX_ATTEMPT_COUNT,
    find_mat_elem_bit_len,
)

from ..ops import prg_torch
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
from ..utils import telemetry

# A rows per stream-mode hint fold: one 16-query tile of the respond
# kernel, which scans the planes once per tile whatever the block size —
# so 111 launches at any m, and a 16 x m x 4-byte block (75 MB at 2^20
# entries) for the XOF to fill before the first fold starts
STREAM_BLOCK_ROWS = 16


def resolve_device(device) -> torch.device:
    """torch.device for a "cpu" or "cuda" request; a CUDA request on a
    machine without CUDA raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise AcceleratorError(f"device {device} requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device} (cpu or cuda)")
    return device


class Server:
    """Stateful PIR server holding the device-resident packed database."""

    def __init__(self, planes: PackedPlanes, num_query_cols: int, num_response_cols: int):
        self._planes = planes
        self._num_query_cols = num_query_cols
        self._num_response_cols = num_response_cols
        self.mat_elem_bit_len = planes.mat_elem_bit_len
        # measured setup attribution, filled by setup()
        self.setup_stats: dict = {}

    @classmethod
    def setup(
        cls,
        seed: bytes,
        db: dict[bytes, bytes],
        arity: int = 3,
        prg_mode: str = "stream",
        rng: np.random.Generator | None = None,
        device="cuda",
        mat_elem_bit_len: int | None = None,
    ) -> tuple["Server", bytes, bytes]:
        """Encode `db`, compute the hint M = A . D, return
        (server, hint_bytes, filter_param_bytes) — byte-identical to
        chalametpir_tpu.Server.setup with the same seed, DB, rng and
        prg_mode ("stream", the default, derives A as the reference does;
        "ctr" generates it on the device; clients must use the same)."""
        if prg_mode not in prg.PRG_MODES:
            raise ValueError(f"unknown prg mode {prg_mode!r}")
        if len(db) == 0:
            raise EmptyKVDatabase()
        if len(seed) != SEED_BYTE_LEN:
            raise ValueError(f"seed must be {SEED_BYTE_LEN} bytes")
        # 0-byte values are permanently unretrievable through the row codec
        if any(len(v) == 0 for v in db.values()):
            raise ValueError("0-byte values are not encodable by the row codec")
        if mat_elem_bit_len is not None and not (
            MIN_CIPHER_TEXT_BIT_LEN <= mat_elem_bit_len <= MAX_CIPHER_TEXT_BIT_LEN
        ):
            raise ImpossibleEncodedDBMatrixElementBitLength()
        device = resolve_device(device)
        if encode_db._native is None:
            raise AcceleratorError("setup needs the native host engine (a C++ compiler to build it)")
        with _gc_paused():
            bit_len = (
                mat_elem_bit_len
                if mat_elem_bit_len is not None
                else find_mat_elem_bit_len(len(db))
            )
            setup = cls._setup_ctr_pipelined if prg_mode == "ctr" else cls._setup_stream
            server, hint, filt = setup(seed, db, arity, bit_len, rng, device)
        return server, matrix_io.matrix_to_bytes(hint), filt.to_bytes()

    @classmethod
    def _setup_stream(cls, seed, db, arity, bit_len, rng, device):
        """Stream-mode setup: encode D on the host (the JAX package's
        encode, so the same rng gives the same filter), upload its packed
        planes, then fold A into the hint STREAM_BLOCK_ROWS rows at a time:
        hint[r0:r0+r] += A[r0:r0+r] . D, with the rows of A as the query
        batch of the respond kernel. A comes from the host XOF, one serial
        sponge read in row order, which a thread runs ahead of the folds
        (the native squeeze releases the GIL); each block is copied to the
        device from pageable memory, a copy that returns once its source
        has been read, so the producer's next block never races it."""
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

        r = STREAM_BLOCK_ROWS
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

        server = cls(planes, m, cols)
        server.setup_stats = {
            "upload_bytes": a_bytes + planes.device_bytes,
            "a_upload_bytes": a_bytes,
            "upload_s": round(phase["pack_upload"] + phase["put"] + phase["drain"], 3),
            "xof_cpu_s": round(xof.get("producer_cpu_s", 0.0), 2),
            "phases_s": {k: round(v, 2) for k, v in phase.items()},
            "wall_s": round(time.perf_counter() - wall0, 2),
        }
        return server, hint_host, filt

    @classmethod
    def _setup_ctr_pipelined(cls, seed, db, arity, bit_len, rng, device):
        """Streaming setup: as each fingerprint-row chunk of D finishes
        encoding it is packed on the host, copied into the device planes,
        and folded into the hint against A's chunk slab generated on the
        device."""
        from chalametpir_tpu.native import engine

        wall0 = time.perf_counter()
        # filter geometry is a function of the DB size alone, so the chunk
        # size is known before the filter is built
        _, _, num_fp = filter_geometry(arity, len(db))
        cc = _ctr_chunk_cols(num_fp, M_ALIGN)
        with telemetry.span("server_setup.encode_stream", entries=len(db), b=bit_len, chunk=cc):
            mat16, filt, chunks = encode_db.from_kv_database_streaming(
                db, arity, bit_len, cc, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng
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

        phase = dict(wait=0.0, pack=0.0, put=0.0, dispatch=0.0, drain=0.0)
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
                t0 = time.perf_counter()
                pack_bufs = lo_host, hi_host = engine.build_packed_planes(
                    mat16[r0 : r0 + cc], cc, c_pad, pack, bits, tight_lo=True, out=pack_bufs
                )
                phase["pack"] += time.perf_counter() - t0

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
                    slab, lo[r0 : r0 + cc], hi[r0 : r0 + cc] if pack else None, bit_len, cols,
                    out=hint,
                )
                phase["dispatch"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            hint_host = hint[:, :cols].cpu().numpy().view(np.uint32)
            phase["drain"] = time.perf_counter() - t0
        telemetry.trace_event("stream_pipeline_phases", **{k: round(v, 2) for k, v in phase.items()})

        server = cls(PackedPlanes(lo, hi, bit_len, m, cols), m, cols)
        server.setup_stats = {
            "upload_bytes": upload_bytes,
            "upload_s": round(phase["put"] + phase["drain"], 3),
            "phases_s": {k: round(v, 2) for k, v in phase.items()},
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
        """(Q, m) uint32 -> (Q, C) uint32, one kernel launch per batch."""
        queries = np.ascontiguousarray(queries, np.uint32)
        if queries.ndim != 2 or queries.shape[1] != self._num_query_cols:
            raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
        # the explicit device (never the calling thread's current one): the
        # TCP dispatcher calls this from a worker thread
        q = torch.from_numpy(queries.view(np.int32)).to(self.device)
        out = respond_batch_packed(q, self._planes)
        return out.cpu().numpy().view(np.uint32)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the serving planes in the JAX package's packed archive
        layout (chalametpir_tpu.Server.save), which either package's
        `load` reads: a `meta` repr, `lo`, `hi` and `tile_k`, the row
        alignment of the planes. The hint and filter params are not in it:
        they left at setup."""
        p = self._planes
        meta = dict(
            backend="jax",
            layout="packed",
            num_query_cols=self._num_query_cols,
            num_response_cols=self._num_response_cols,
            mat_elem_bit_len=self.mat_elem_bit_len,
        )
        arrays = dict(lo=p.lo.cpu().numpy(), tile_k=np.array([M_ALIGN]))
        if p.hi is not None:
            arrays["hi"] = p.hi.cpu().numpy()
        # through a file handle: np.savez(str) appends ".npz" to a path
        # without a suffix, which load would then not find
        with open(path, "wb") as f:
            np.savez(f, meta=np.array([repr(meta)]), **arrays)

    @classmethod
    def load(cls, path: str, device="cuda") -> "Server":
        """Rebuild a serving-ready Server on `device` from an archive that
        either package's `save` wrote. Packed planes load as they are; the
        JAX package's numpy (`mat_d`) and digit2 archives (`d0`, `d1`, with
        D = d0 + 256 d1) hold D itself, which is packed here."""
        device = resolve_device(device)
        with np.load(path) as archive:
            meta = ast.literal_eval(str(archive["meta"][0]))
            b, m, c = meta["mat_elem_bit_len"], meta["num_query_cols"], meta["num_response_cols"]
            if meta["backend"] == "numpy":
                planes = build_packed_db(archive["mat_d"], b, device)
            elif meta["layout"] == "packed":
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
                d = archive["d0"].astype(np.int32) + 256 * archive["d1"].astype(np.int32)
                planes = build_packed_db(d.astype(np.uint16), b, device)
            else:
                raise ValueError(f"unknown archive layout {meta['layout']!r}")
        return cls(planes, m, c)

    @property
    def planes(self) -> PackedPlanes:
        return self._planes

    @property
    def device(self) -> torch.device:
        return self._planes.device

    @property
    def num_query_cols(self) -> int:
        return self._num_query_cols

    @property
    def num_response_cols(self) -> int:
        return self._num_response_cols
