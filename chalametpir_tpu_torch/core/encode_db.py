"""Encode a key-value database into the filter matrix D.

Host-side DB encoding pipeline (reference:
chalametpir_common/src/matrix.rs:633-945):

1. batch-hash every key (vectorised TurboSHAKE),
2. build the binary fuse filter (peel order),
3. batch-encode every (hashed_key, value) row,
4. walk the peel order in reverse, assigning
       D[h_found] = (enc_row - sum(D[h_other]) - mask(hash, col)) mod 2^b.

Step 4 is a sequential scatter/gather chain (each row may read rows
assigned later in the walk); the native engine runs steps 3-4 fused. The
port's copy of chalametpir_tpu/core/encode_db.py, whose numpy loop is the
semantic reference.
"""

from __future__ import annotations

import numpy as np

from ..errors import EmptyKVDatabase
from ..params import SERVER_SETUP_MAX_ATTEMPT_COUNT
from . import codec, hashing
from .filter import BinaryFuseFilter, construct_filter, hash_batch

from ..native import engine as _native


def _reject_empty_values(values: list[bytes]) -> None:
    """0-byte values encode fine but are PERMANENTLY unretrievable: the
    row codec requires the 0x81 boundary marker strictly after the 32-byte
    digest (serialization.rs:164-183 and our codec alike), so an empty
    value always decodes as RowNotDecodable. Reject at encode depth so
    direct core users surface the data loss at setup, not at every future
    query (Server.setup has the same guard with a friendlier message)."""
    if any(len(v) == 0 for v in values):
        raise ValueError("0-byte values are not encodable by the row codec")


def from_kv_database(
    db: dict[bytes, bytes],
    arity: int,
    mat_elem_bit_len: int,
    max_attempt_count: int = SERVER_SETUP_MAX_ATTEMPT_COUNT,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, BinaryFuseFilter]:
    """Encode `db` into an (num_fingerprints, cols) uint32 matrix D plus its
    filter (reference: matrix.rs:633-894)."""
    if len(db) == 0:
        raise EmptyKVDatabase()
    keys = list(db.keys())
    values = list(db.values())
    _reject_empty_values(values)

    digests = hashing.hash_of_keys_batch(keys)  # (n, 4) uint64 words
    filt, reverse_order, reverse_h, key_index = construct_filter(
        digests, arity, mat_elem_bit_len, max_attempt_count, rng
    )

    max_value_len = max(len(v) for v in values)
    cols = codec.encoded_row_width(max_value_len, mat_elem_bit_len)

    digest_bytes = np.ascontiguousarray(digests).view(np.uint8).reshape(len(keys), 32)
    # D is stored uint16: elements are < 2^b <= 2^14 and every mod-2^b
    # identity commutes with mod-2^16 wraparound — half the footprint and
    # host-memory traffic of a uint32 matrix
    mat = _native.encode_assemble_rows16(
        digest_bytes,
        values,
        key_index,
        reverse_order,
        reverse_h,
        mat_elem_bit_len,
        cols,
        filt.num_fingerprints,
        filt.arity,
        filt.segment_length,
        filt.segment_count_length,
    )
    return mat, filt


def from_kv_database_streaming(
    db: dict[bytes, bytes],
    arity: int,
    mat_elem_bit_len: int,
    chunk_rows: int,
    max_attempt_count: int = SERVER_SETUP_MAX_ATTEMPT_COUNT,
    rng: np.random.Generator | None = None,
    stats: dict | None = None,
):
    """Streaming encode: returns (mat16, filt, chunk_iter) where mat16 is
    the (num_fingerprints, cols) uint16 matrix being assembled on a worker
    thread in fingerprint-chunk order, and chunk_iter yields each chunk
    index j as rows [j*chunk_rows, (j+1)*chunk_rows) become final. The
    consumer packs/uploads chunk j while chunks j+1.. are still being
    assembled — the encode pass hides under the device upload.

    Semantics identical to from_kv_database: the chunk-ordered execution
    is a valid topological order of the reverse-peel assignment
    (reference: matrix.rs:707-746 — see engine.cpp for the argument)."""
    import threading
    import time

    if len(db) == 0:
        raise EmptyKVDatabase()
    from ..utils import telemetry

    with telemetry.span("encode_stream.listify"):
        keys = list(db.keys())
        values = list(db.values())
    _reject_empty_values(values)

    with telemetry.span("encode_stream.hash"):
        digests = hashing.hash_of_keys_batch(keys)
    with telemetry.span("encode_stream.filter"):
        filt, reverse_order, reverse_h, key_index = construct_filter(
            digests, arity, mat_elem_bit_len, max_attempt_count, rng
        )
    with telemetry.span("encode_stream.vscan"):
        max_value_len = max(len(v) for v in values)
    cols = codec.encoded_row_width(max_value_len, mat_elem_bit_len)
    digest_bytes = np.ascontiguousarray(digests).view(np.uint8).reshape(len(keys), 32)

    num_fp = filt.num_fingerprints
    n_chunks = -(-num_fp // chunk_rows)
    with telemetry.span("encode_stream.plan"):
        expected = _native.assemble_plan(
            reverse_order, reverse_h, filt.arity, filt.segment_length,
            filt.segment_count_length, chunk_rows, n_chunks,
        )
    progress = np.zeros(n_chunks, np.int64)
    # rows are padded to whole chunks (zeros) so every chunk the consumer
    # packs/uploads has the same shape — one compiled device program.
    # LAZY zeros, deliberately: in a long-lived process (measured with
    # the JAX package's runtime live) EVERY new page mapping costs
    # 27-172 us of sys time (vs
    # ~1.2 us fresh — r5 bench, sys-dominated with minflt == page count;
    # THP ruled out, NOHUGEPAGE+MADV_POPULATE_WRITE measured identically
    # degraded, and MADV_HUGEPAGE populate is pathological here: 239 s
    # for 2 GB). A front-loaded populate of this GB-scale matrix
    # serializes that cost (measured 358 s at 2^22); lazy first-touch
    # lands it on the encode worker thread instead, where it overlaps
    # the chunk uploads that bound the pipeline anyway. The worker's
    # cpu/minflt stats keep the cost attributed.
    with telemetry.span("encode_stream.alloc", mb=n_chunks * chunk_rows * cols * 2 >> 20):
        mat = np.zeros((n_chunks * chunk_rows, cols), np.uint16)

    def _worker_main():
        # the worker's CPU seconds feed the setup attribution (bench
        # floor fields): on this single-core host, wall = main CPU +
        # worker CPU + runtime-thread CPU + external, and each term must
        # be measured, not modeled. The minor-fault delta separates
        # page-fault fill (first touch of `mat`, slow late in a
        # long-lived process) from assembly compute.
        from ..utils.telemetry import thread_rusage

        t0 = time.thread_time()
        ru0 = thread_rusage()
        try:
            _native.encode_assemble_rows16_ordered(
                digest_bytes, values, key_index, reverse_order, reverse_h,
                mat_elem_bit_len, filt.arity, filt.segment_length,
                filt.segment_count_length, mat, chunk_rows, progress,
            )
        finally:
            if stats is not None:
                ru1 = thread_rusage()
                stats["worker_cpu_s"] = time.thread_time() - t0
                stats["worker_minflt"] = ru1.ru_minflt - ru0.ru_minflt

    worker = threading.Thread(target=_worker_main, daemon=True)
    worker.start()

    def chunk_iter():
        # acquire-ordered poll: the worker publishes each row with a
        # release increment, so this load ordering (not a plain numpy
        # read) is what guarantees the mat rows read after it are the
        # written ones on weakly-ordered hosts
        for j in range(n_chunks):
            while _native.progress_load_acquire(progress, j) < expected[j]:
                if (not worker.is_alive()
                        and _native.progress_load_acquire(progress, j) < expected[j]):
                    raise RuntimeError("streaming encode worker died")
                time.sleep(0.002)
            yield j
        worker.join()

    return mat, filt, chunk_iter()


def recover_value(
    mat: np.ndarray, key: bytes, filt: BinaryFuseFilter
) -> bytes:
    """Plaintext recovery of a value straight from D — the non-private dual
    of the PIR path, used by tests (reference: matrix.rs:769-805, 908-945)."""
    from ..errors import DecodedRowNotPrependedWithDigestOfKey

    digest = hashing.hash_of_key(key)
    h = hashing.mix256(digest, filt.seed)
    rows = hash_batch(filt.arity, h, filt.segment_length, filt.segment_count_length)
    mask = np.uint32((1 << filt.mat_elem_bit_len) - 1)
    acc = np.zeros(mat.shape[1], dtype=np.uint32)
    for r in rows:
        acc += mat[int(r)]
    mask_row = hashing.row_mask(int(h), mat.shape[1], 32)
    row = (acc + mask_row) & mask

    kv = codec.decode_kv_from_row(row, filt.mat_elem_bit_len)
    digest_bytes = np.asarray(digest).view(np.uint8).tobytes()
    if kv[:32] != digest_bytes:
        raise DecodedRowNotPrependedWithDigestOfKey()
    return kv[32:]
