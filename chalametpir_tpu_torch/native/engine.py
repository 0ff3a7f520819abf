"""ctypes bindings for the port's native host engine (engine.cpp).

The port's copy of chalametpir_tpu/native/engine.cpp and engine.py. The
library is built with g++ on first use, never at import, into `_build/`
next to the package's kernels, keyed by a digest of the source, the
flags and the CPU's flag line; a second process waits on a file lock and
reuses the result. There is no numpy fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "engine.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# -O3 is not optional: without it the XOF runs ~10x slower. -march=native
# is why the CPU's flag line is in the digest: a library built on one CPU
# can SIGILL on another.
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None
_load_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + platform.machine().encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # the ISA extension list: "flags" on x86, "Features" on arm64
                if line.startswith(("flags", "Features")):
                    h.update(line.encode())
                    break
    except OSError:
        pass
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the engine if this source, these flags and this CPU have no
    library yet; returns its path. Raises when the compiler fails."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libchalametpir_native_{_digest()}.so")
    with open(os.path.join(BUILD_DIR, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"native engine build failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
    return so


_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u16p = ctypes.POINTER(ctypes.c_uint16)


def _load():
    """The loaded library, built on the first call."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(build()))
    return _lib


def _bind(lib):
    lib.ts128_xof_new.restype = ctypes.c_void_p
    lib.ts128_xof_new.argtypes = [_u8p, ctypes.c_int64]
    lib.ts128_xof_squeeze.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64]
    lib.ts128_xof_free.argtypes = [ctypes.c_void_p]
    lib.ts128_hash_keys.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p]
    lib.ts128_ctr_expand.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p,
    ]
    lib.bff_peel.restype = ctypes.c_int32
    lib.bff_peel.argtypes = [
        _u64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, _u64p, _u8p,
    ]
    lib.encode_rows.argtypes = [
        _u8p, _u8p, _i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, _u32p,
    ]
    lib.assemble_rows.argtypes = [
        _u32p, _u32p, _u64p, _u8p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32,
    ]
    lib.encode_assemble_rows16.argtypes = [
        _u8p, ctypes.POINTER(ctypes.c_char_p), _i64p, _i64p, _u64p, _u8p,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, _u16p,
    ]
    lib.assemble_plan.argtypes = [
        _u64p, _u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_int64, _i64p,
    ]
    lib.encode_assemble_rows16_ordered.argtypes = [
        _u8p, ctypes.POINTER(ctypes.c_char_p), _i64p, _i64p, _u64p, _u8p,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _i64p,
    ]
    lib.progress_load_acquire.restype = ctypes.c_int64
    lib.progress_load_acquire.argtypes = [_i64p, ctypes.c_int64]
    lib.build_packed_planes16.argtypes = [
        _u16p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i8p, _u8p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.chacha8_ternary.argtypes = [_u8p, ctypes.c_int64, _i8p]
    lib.ternary_matvec.argtypes = [_i8p, _u32p, ctypes.c_int64, ctypes.c_int64, _u32p]
    lib.mix_row_mask.argtypes = [ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32, _u32p]
    lib.mix256_scalar.restype = ctypes.c_uint64
    lib.mix256_scalar.argtypes = [_u64p, _u8p]
    lib.decrypt_decode_row.restype = ctypes.c_int64
    lib.decrypt_decode_row.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, _u8p,
    ]
    lib.client_process_response.restype = ctypes.c_int64
    lib.client_process_response.argtypes = [
        _u8p, ctypes.c_int64, _u8p, _u32p, _u32p, ctypes.c_int64, ctypes.c_int32, _u8p,
    ]
    # hot-path signature: bytes in, raw addresses for the arrays (c_char_p
    # conversion from bytes is ctypes' fastest zero-copy path; c_void_p takes
    # plain ints from arr.ctypes.data, skipping data_as() object churn)
    lib.client_process_response_wire.restype = ctypes.c_int64
    lib.client_process_response_wire.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.pir_alloc_populated.restype = ctypes.c_void_p
    lib.pir_alloc_populated.argtypes = [ctypes.c_int64]
    lib.pir_alloc_populated_nothp.restype = ctypes.c_void_p
    lib.pir_alloc_populated_nothp.argtypes = [ctypes.c_int64]
    lib.pir_alloc_populated_huge.restype = ctypes.c_void_p
    lib.pir_alloc_populated_huge.argtypes = [ctypes.c_int64]
    lib.pir_free_populated.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.build_packed_planes.argtypes = [
        _u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i8p, _u8p, ctypes.c_int32, ctypes.c_int32,
    ]
    return lib


def alloc_array(shape, dtype, nothp: bool = False, huge: bool = False) -> np.ndarray:
    """Zero-filled numpy array over a MAP_POPULATE mapping — use for
    GB-scale buffers (demand paging on this class of VM makes filling a
    plain np.empty several times slower).

    nothp=True additionally opts the range out of transparent huge pages
    and fills it via MADV_POPULATE_WRITE: in a long-lived process the
    plain populate/first-touch path degrades ~10x (huge-page direct
    compaction on a fragmented heap), which made every late-running
    GB-scale setup pay minutes — use for setup-time buffers whose fill
    time matters more than the read-path TLB win."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    # threshold: one mmap+populate syscall costs ~0.5 ms of setup but fills
    # pages ~10x faster than fault-on-write on this VM; break-even ~1 MB
    if nbytes < (1 << 20):
        return np.zeros(shape, dtype)
    if huge:
        alloc = _load().pir_alloc_populated_huge
    elif nothp:
        alloc = _load().pir_alloc_populated_nothp
    else:
        alloc = _load().pir_alloc_populated
    ptr = alloc(nbytes)
    if not ptr:
        return np.zeros(shape, dtype)
    raw = (ctypes.c_uint8 * nbytes).from_address(ptr)
    arr = np.frombuffer(raw, dtype=np.uint8, count=nbytes).view(dtype).reshape(shape)
    # free the mapping when the array's base buffer dies
    import weakref

    weakref.finalize(raw, _load().pir_free_populated, ptr, nbytes)
    return arr


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctype)


class XofStream:
    """Streaming TurboSHAKE128 squeeze (absorbs once at construction)."""

    def __init__(self, seed: bytes) -> None:
        buf = np.frombuffer(seed, np.uint8)
        self._handle = _load().ts128_xof_new(_ptr(buf, _u8p), len(seed))

    def squeeze(self, n: int) -> np.ndarray:
        # nothp: the multi-GB stream-mode A expansion is a setup-time fill
        # (the r5 bench measured a 20x degraded populate late in-process)
        out = alloc_array((n,), np.uint8, nothp=True)
        _load().ts128_xof_squeeze(self._handle, _ptr(out, _u8p), n)
        return out

    def squeeze_u32(self, count: int) -> np.ndarray:
        return self.squeeze(count * 4).view("<u4")

    def squeeze_into(self, out: np.ndarray) -> None:
        """Squeeze directly into a caller-allocated buffer (lets callers
        time allocation and XOF separately — the r5 bench showed the
        late-process allocation cost dominating and masquerading as
        "slow XOF")."""
        _load().ts128_xof_squeeze(self._handle, _ptr(out, _u8p), out.nbytes)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        # _lib may already be torn down at interpreter shutdown
        if handle and _lib is not None:
            _lib.ts128_xof_free(handle)
            self._handle = None


def turboshake128(data: bytes, out_len: int) -> bytes:
    return XofStream(data).squeeze(out_len).tobytes()


def ctr_expand(seed: bytes, block0: int, nblocks: int) -> np.ndarray:
    """Counter-mode expansion: (nblocks, 168) uint8, block i =
    TurboSHAKE128(seed || LE64(block0 + i))[:168]."""
    buf = np.frombuffer(seed, np.uint8)
    out = alloc_array((nblocks, 168), np.uint8, nothp=True)
    _load().ts128_ctr_expand(_ptr(buf, _u8p), len(seed), block0, nblocks, _ptr(out, _u8p))
    return out


def hash_keys(keys: list[bytes]) -> np.ndarray:
    """(n, 4) uint64 digest words, like core.hashing.hash_of_keys_batch."""
    n = len(keys)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, keys), np.int64, count=n), out=offsets[1:])
    data = np.frombuffer(b"".join(keys), np.uint8) if offsets[-1] else np.zeros(1, np.uint8)
    out = np.empty((n, 32), np.uint8)
    _load().ts128_hash_keys(_ptr(data, _u8p), _ptr(offsets, _i64p), n, _ptr(out, _u8p))
    return out.view("<u8").reshape(n, 4)


def _check_geometry(arity: int, seg_len: int, seg_cnt_len: int,
                    num_fp: int | None = None) -> int:
    """The C side indexes its slot/count/matrix arrays with hash_batch
    rows and trusts these params completely — enforce at this binding (the
    declared trust boundary) the same structural contract
    core.filter.BinaryFuseFilter.from_bytes enforces for wire blobs: a
    power-of-two seg_len, seg_cnt_len a positive multiple of it, and
    num_fp covering the full hash row space. Returns that row space."""
    if arity not in (3, 4):
        raise ValueError("arity must be 3 or 4")
    if seg_len <= 0 or (seg_len & (seg_len - 1)) != 0:
        raise ValueError("segment_length must be a positive power of two")
    if seg_cnt_len < seg_len or seg_cnt_len % seg_len != 0:
        raise ValueError(
            "segment_count_length must be a positive multiple of segment_length"
        )
    span = seg_cnt_len + (arity - 1) * seg_len
    if num_fp is not None and num_fp < span:
        raise ValueError("num_fingerprints smaller than the hash row space")
    return span


def _check_peel_codes(reverse_h: np.ndarray, arity: int) -> None:
    """reverse_h codes select among `arity` hash rows in C with no bounds
    check (a bad code reads a garbage row index off the stack and writes
    matrix rows at an attacker-influenced offset)."""
    if reverse_h.size and int(reverse_h.max()) >= arity:
        raise ValueError("reverse_h code out of range for arity")


def _check_row_capacity(value_lens: np.ndarray, b: int, cols: int) -> None:
    """Every encoded stream (32-byte digest + value + 0x81 marker) must
    fit the cols*b-bit row: an oversized value would overflow the C scratch
    buffer (and size_t-underflow its tail memset). Construction sizes cols
    from the max value length, so a violation here is caller error."""
    if value_lens.size and (33 + int(value_lens.max())) * 8 > cols * b:
        raise ValueError("value too long for the cols*b row capacity")


def bff_peel(hashes: np.ndarray, num_fp: int, arity: int, seg_len: int, seg_cnt_len: int):
    """Returns (reverse_order, reverse_h) or None when peeling stalls."""
    _check_geometry(arity, seg_len, seg_cnt_len, num_fp)
    hashes = np.ascontiguousarray(hashes, np.uint64)
    n = hashes.shape[0]
    reverse_order = np.empty(n, np.uint64)
    reverse_h = np.empty(n, np.uint8)
    ok = _load().bff_peel(
        _ptr(hashes, _u64p), n, num_fp, arity, seg_len, seg_cnt_len,
        _ptr(reverse_order, _u64p), _ptr(reverse_h, _u8p),
    )
    if ok < 0:
        # the C side caught bad_alloc on its ~13 B/slot working vectors
        # (letting it unwind through the FFI would abort the process)
        raise MemoryError(f"bff_peel working set for {num_fp} slots")
    if not ok:
        return None
    return reverse_order, reverse_h


def encode_rows(digests: np.ndarray, values: list[bytes], b: int, cols: int) -> np.ndarray:
    digests = np.ascontiguousarray(digests, np.uint8)
    n = digests.shape[0]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, values), np.int64, count=n), out=offsets[1:])
    _check_row_capacity(np.diff(offsets), b, cols)
    data = np.frombuffer(b"".join(values), np.uint8) if offsets[-1] else np.zeros(1, np.uint8)
    out = alloc_array((n, cols), np.uint32)
    _load().encode_rows(
        _ptr(digests, _u8p), _ptr(data, _u8p), _ptr(offsets, _i64p), n, b, cols, _ptr(out, _u32p)
    )
    return out


def assemble_rows(mat, enc_rows, reverse_order, reverse_h, hrows, b, *, filt=None,
                  arity=None, seg_len=None, seg_cnt_len=None):
    """In-place reverse-peel-order assembly into `mat` (num_fp, cols)."""
    del hrows  # recomputed natively from the hashes
    n, cols = enc_rows.shape
    mat_c = np.ascontiguousarray(mat, np.uint32)
    enc_c = np.ascontiguousarray(enc_rows, np.uint32)
    ro = np.ascontiguousarray(reverse_order, np.uint64)
    rh = np.ascontiguousarray(reverse_h, np.uint8)
    _check_geometry(arity, seg_len, seg_cnt_len, mat_c.shape[0])
    _check_peel_codes(rh, arity)
    _load().assemble_rows(
        _ptr(mat_c, _u32p), _ptr(enc_c, _u32p), _ptr(ro, _u64p), _ptr(rh, _u8p),
        n, cols, arity, seg_len, seg_cnt_len, b,
    )
    if mat_c is not mat:
        mat[...] = mat_c
    return mat


def encode_assemble_rows16(
    digests: np.ndarray,
    values: list[bytes],
    key_index: np.ndarray,
    reverse_order: np.ndarray,
    reverse_h: np.ndarray,
    b: int,
    cols: int,
    num_fp: int,
    arity: int,
    seg_len: int,
    seg_cnt_len: int,
) -> np.ndarray:
    """Fused encode + reverse-peel assembly -> (num_fp, cols) uint16 matrix D.

    digests/values are in original key order; key_index maps peel position
    to original row. Skips the GB-scale encoded-rows intermediate of the
    separate encode_rows/assemble_rows pair, and reads each value straight
    from its Python bytes object (no GB-scale join)."""
    digests = np.ascontiguousarray(digests, np.uint8)
    n = digests.shape[0]
    # c_char_p conversion borrows each bytes object's buffer — zero copy
    value_ptrs = (ctypes.c_char_p * n)(*values)
    value_lens = np.fromiter((len(v) for v in values), np.int64, count=n)
    ki = np.ascontiguousarray(key_index, np.int64)
    ro = np.ascontiguousarray(reverse_order, np.uint64)
    rh = np.ascontiguousarray(reverse_h, np.uint8)
    _check_geometry(arity, seg_len, seg_cnt_len, num_fp)
    _check_peel_codes(rh, arity)
    _check_row_capacity(value_lens, b, cols)
    if ki.size and (int(ki.min()) < 0 or int(ki.max()) >= n):
        raise ValueError("key_index out of range")
    mat = alloc_array((num_fp, cols), np.uint16, nothp=True)
    _load().encode_assemble_rows16(
        _ptr(digests, _u8p), value_ptrs, _ptr(value_lens, _i64p),
        _ptr(ki, _i64p), _ptr(ro, _u64p), _ptr(rh, _u8p),
        n, b, cols, arity, seg_len, seg_cnt_len, _ptr(mat, _u16p),
    )
    return mat


def assemble_plan(
    reverse_order: np.ndarray,
    reverse_h: np.ndarray,
    arity: int,
    seg_len: int,
    seg_cnt_len: int,
    chunk_rows: int,
    n_chunks: int,
) -> np.ndarray:
    """(n_chunks,) int64 expected write counts per fingerprint-row chunk —
    the completion targets for the streaming encode's progress array."""
    ro = np.ascontiguousarray(reverse_order, np.uint64)
    rh = np.ascontiguousarray(reverse_h, np.uint8)
    span = _check_geometry(arity, seg_len, seg_cnt_len)
    _check_peel_codes(rh, arity)
    if chunk_rows <= 0 or n_chunks * chunk_rows < span:
        raise ValueError("chunk grid does not cover the hash row space")
    expected = np.zeros(n_chunks, np.int64)
    _load().assemble_plan(
        _ptr(ro, _u64p), _ptr(rh, _u8p), ro.shape[0], arity, seg_len,
        seg_cnt_len, chunk_rows, n_chunks, _ptr(expected, _i64p),
    )
    return expected


def encode_assemble_rows16_ordered(
    digests: np.ndarray,
    values: list[bytes],
    key_index: np.ndarray,
    reverse_order: np.ndarray,
    reverse_h: np.ndarray,
    b: int,
    arity: int,
    seg_len: int,
    seg_cnt_len: int,
    mat: np.ndarray,
    chunk_rows: int,
    progress: np.ndarray,
) -> None:
    """Chunk-ordered encode+assemble into the preallocated uint16 `mat`
    (num_fp rows, zero-initialised): same result as encode_assemble_rows16
    but fingerprint chunks complete in order, with progress[k] counting
    chunk k's written rows (poll against assemble_plan). ctypes releases
    the GIL for the call, so run it on a worker thread and consume chunks
    from the main thread."""
    digests = np.ascontiguousarray(digests, np.uint8)
    n = digests.shape[0]
    value_ptrs = (ctypes.c_char_p * n)(*values)
    value_lens = np.fromiter((len(v) for v in values), np.int64, count=n)
    ki = np.ascontiguousarray(key_index, np.int64)
    ro = np.ascontiguousarray(reverse_order, np.uint64)
    rh = np.ascontiguousarray(reverse_h, np.uint8)
    num_fp, cols = mat.shape
    n_chunks = progress.shape[0]
    _check_geometry(arity, seg_len, seg_cnt_len, num_fp)
    _check_peel_codes(rh, arity)
    _check_row_capacity(value_lens, b, cols)
    if ki.size and (int(ki.min()) < 0 or int(ki.max()) >= n):
        raise ValueError("key_index out of range")
    if chunk_rows <= 0 or n_chunks * chunk_rows < num_fp:
        raise ValueError("chunk grid does not cover the matrix rows")
    _load().encode_assemble_rows16_ordered(
        _ptr(digests, _u8p), value_ptrs, _ptr(value_lens, _i64p),
        _ptr(ki, _i64p), _ptr(ro, _u64p), _ptr(rh, _u8p),
        n, b, cols, arity, seg_len, seg_cnt_len, _ptr(mat, _u16p),
        num_fp, chunk_rows, n_chunks, _ptr(progress, _i64p),
    )


def progress_load_acquire(progress: np.ndarray, idx: int) -> int:
    """Acquire-ordered read of progress[idx] — pairs with the worker's
    release increments so the chunk rows observed after this read are the
    ones the worker wrote (a plain numpy load only suffices on TSO)."""
    return _load().progress_load_acquire(_ptr(progress, _i64p), idx)


def chacha8_ternary(entropy32: bytes, n: int) -> np.ndarray:
    """(n,) int8 uniform ternary codes {0,1,2} from a ChaCha8 CSPRNG keyed
    with 32 bytes of caller-supplied (OS) entropy."""
    key = np.frombuffer(entropy32, np.uint8)
    if key.size != 32:
        raise ValueError("chacha8_ternary needs exactly 32 bytes of entropy")
    out = np.empty(n, np.int8)
    _load().chacha8_ternary(_ptr(key, _u8p), n, _ptr(out, _i8p))
    return out


def ternary_matvec(codes: np.ndarray, mat: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.int8)
    mat = np.ascontiguousarray(mat, np.uint32)
    k, m = mat.shape
    if codes.shape[0] != k:
        # C reads codes[r] for every matrix row: a short vector would feed
        # out-of-bounds garbage bytes in as secret coefficients
        raise ValueError("codes length != matrix rows")
    out = np.empty(m, np.uint32)
    _load().ternary_matvec(_ptr(codes, _i8p), _ptr(mat, _u32p), k, m, _ptr(out, _u32p))
    return out


def mix256_scalar(key_words: np.ndarray, seed: bytes) -> int:
    """Fold one 4-word hashed key with a 32-byte seed -> fused uint64."""
    kw = np.ascontiguousarray(key_words, np.uint64)
    sw = np.frombuffer(seed, np.uint8)
    if sw.size != 32:  # C memcpys 32 bytes unconditionally
        raise ValueError("filter seed must be 32 bytes")
    return int(_load().mix256_scalar(_ptr(kw, _u64p), _ptr(sw, _u8p)))


def decrypt_decode_row(resp: np.ndarray, vec_c: np.ndarray, b: int, h: int) -> bytes | None:
    """Full response post-processing (decrypt, unmask, decode, validate);
    returns the kv bytes (digest || value) or None when not decodable."""
    resp = np.ascontiguousarray(resp, np.uint32)
    vec_c = np.ascontiguousarray(vec_c, np.uint32)
    cols = resp.shape[0]
    out = np.zeros((cols * b) // 8 + 1, np.uint8)
    n = _load().decrypt_decode_row(
        _ptr(resp, _u32p), _ptr(vec_c, _u32p), cols, b, ctypes.c_uint64(h), _ptr(out, _u8p)
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def client_process_response(
    key: bytes, filter_seed: bytes, resp: np.ndarray, vec_c: np.ndarray, b: int
) -> bytes | int:
    """Full response handling in one native call: hash key, fold with the
    filter seed, decrypt+decode, verify the digest prefix. Returns the
    value bytes, or -1 (not decodable) / -2 (digest mismatch)."""
    kb = np.frombuffer(key, np.uint8) if key else np.zeros(1, np.uint8)
    sb = np.frombuffer(filter_seed, np.uint8)
    if sb.size != 32:  # the C mix256 memcpys 32 bytes unconditionally
        raise ValueError("filter seed must be 32 bytes")
    resp = np.ascontiguousarray(resp, np.uint32)
    vec_c = np.ascontiguousarray(vec_c, np.uint32)
    cols = resp.shape[0]
    out = np.zeros((cols * b) // 8 + 1, np.uint8)
    n = _load().client_process_response(
        _ptr(kb, _u8p), len(key), _ptr(sb, _u8p),
        _ptr(resp, _u32p), _ptr(vec_c, _u32p), cols, b, _ptr(out, _u8p),
    )
    if n < 0:
        return int(n)
    return out[32 : 32 + n].tobytes()


def client_process_response_wire(
    key: bytes,
    filter_seed: bytes,
    response_bytes: bytes,
    vec_c_ptr: int,
    cols: int,
    b: int,
    out_ptr: int,
) -> int:
    """Wire-level response handling: the serialized response goes straight
    to C (header parse included). vec_c_ptr/out_ptr are raw addresses
    (callers cache arr.ctypes.data — the property costs ~1 us per access,
    real money at a ~10 us budget). Returns the value length or -1/-2/-3;
    on success out[32:32+n] holds the value (out[:32] the digest)."""
    if len(filter_seed) != 32:  # the C mix256 memcpys 32 bytes
        raise ValueError("filter seed must be 32 bytes")
    return _load().client_process_response_wire(
        key, len(key), filter_seed, response_bytes, len(response_bytes),
        vec_c_ptr, cols, b, out_ptr,
    )


def mix_row_mask(h: int, cols: int, mask: int) -> np.ndarray:
    out = np.empty(cols, np.uint32)
    _load().mix_row_mask(ctypes.c_uint64(h), cols, ctypes.c_uint32(mask), _ptr(out, _u32p))
    return out


def build_packed_planes(
    mat: np.ndarray, m_pad: int, c_pad: int, pack: int, bits: int,
    tight_lo: bool = False, out=None,
):
    """One-pass construction of (lo, hi_packed) host planes in the packed
    respond layout; hi is None when pack == 0. Accepts the uint16 D matrix
    (the storage format) or uint32 (legacy/tests).

    tight_lo (uint16 path only): emit lo as (m, c) with no padding — the
    caller pads on device so zero columns never cross the host link.

    out: a (lo, hi) pair from a previous same-shape call to write into
    instead of allocating fresh buffers. The streaming setup reuses two
    pairs round-robin: per-chunk MAP_POPULATE allocations degrade badly
    late in a long-lived process (measured in BENCH r5: the arity-4
    row, which always runs late, paid ~45 s of extra main+worker CPU at
    2^20 that a fresh process does not). The caller must not reuse a
    pair until the device transfers reading it have completed."""
    m, c = mat.shape
    if mat.dtype == np.uint16:
        mat = np.ascontiguousarray(mat)
        fn, ptr_t = _load().build_packed_planes16, _u16p
        lo_rows, lo_stride = (m, c) if tight_lo else (m_pad, c_pad)
    else:
        if tight_lo:
            raise ValueError("tight_lo requires the uint16 storage format")
        mat = np.ascontiguousarray(mat, np.uint32)
        fn, ptr_t = _load().build_packed_planes, _u32p
        lo_rows, lo_stride = m_pad, c_pad
    pc = (c_pad // pack if pack > 1 else c_pad) if pack else 0
    if out is not None and out[0] is not None:
        lo, hi = out
        if lo.shape != (lo_rows, lo_stride) or (
            pack != 0 and (hi is None or hi.shape != (m_pad, pc))
        ):
            raise ValueError("out buffers do not match the requested shape")
        if hi is not None:
            hi.fill(0)  # the hi pack ORs field-by-field into zeroed words
    else:
        lo = alloc_array((lo_rows, lo_stride), np.int8, nothp=True)
        hi = alloc_array((m_pad, pc), np.uint8, nothp=True) if pack else None
    if lo_rows > m:
        # padded rows hold biased -128 == value zero (exact for any query,
        # not just zero-padded ones — the hint folds rely on this)
        lo[m:] = -128
    if pack == 0:
        fn(
            _ptr(mat, ptr_t), m, c, lo_stride, c_pad, _ptr(lo, _i8p),
            ctypes.cast(None, _u8p), 0, 0,
        )
        return lo, None
    fn(
        _ptr(mat, ptr_t), m, c, lo_stride, c_pad, _ptr(lo, _i8p), _ptr(hi, _u8p), pack, bits
    )
    return lo, hi
