"""Public-matrix expansion: seed -> LWE matrix A via TurboSHAKE128.

Two derivation modes:

* **stream** (default, wire-compatible with the reference): the 32-byte
  seed is absorbed once and one sequential XOF stream is read row-major
  into uint32 LE elements (reference:
  chalametpir_common/src/matrix.rs:541-558). A single sponge stream
  cannot be parallelised, so this mode is host-bound on one core.

* **ctr** (device-native): byte block i of the stream is
  `TurboSHAKE128(seed || LE64(i))[:168]`. Blocks are independent, so the
  expansion runs batched on the host (the native engine) or entirely on
  the device (ops/prg_torch.py, the ctr Keccak kernel) — the server then never ships A
  over the host link at all. Same cost per byte (one Keccak-p[1600,12]
  permutation per 168 bytes), same security argument (each block is an
  independent XOF output of a distinct message under the public seed);
  not interoperable with reference peers, which is why it is opt-in.

  ctr mode lays A out **fingerprint-major**: element A[r, c] is stream
  word `c * rows + r`, i.e. each fingerprint column of A is a contiguous
  word range. Every consumer slices A by fingerprint ranges — the
  sharded hint generates only each shard's local range, the setup
  pipeline folds hint chunks as DB chunks finish uploading, and the
  client generates per-fingerprint-chunk slabs — so this orientation
  makes all of them contiguous ctr-stream reads. (A is uniform either
  way; the orientation is a layout choice, not a security change.)

Both modes expose the same API surface: full expansion and a row-block
iterator the server uses to pipeline the hint matmul. The port's copy of
chalametpir_tpu/core/prg.py, on the native engine.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..native import engine as _native
from .keccak import RATE, TurboShake128, turboshake128_batch  # noqa: F401  (re-exported, as in the JAX package)

PRG_MODES = ("stream", "ctr")


class SeedStream:
    """Streaming squeeze of the matrix byte stream (either mode)."""

    def __init__(self, seed: bytes, mode: str = "stream") -> None:
        if mode not in PRG_MODES:
            raise ValueError(f"unknown prg mode {mode!r}")
        self._mode = mode
        self._seed = seed
        self._block = 0  # next ctr block
        self._carry = b""
        if mode == "stream":
            self._native = _native.XofStream(seed)

    def read_u32(self, count: int) -> np.ndarray:
        nbytes = count * 4
        if self._mode == "stream":
            return self._native.squeeze_u32(count)

        need = nbytes - len(self._carry)
        nblocks = max(0, -(-need // RATE))
        blocks = _ctr_blocks(self._seed, self._block, nblocks)
        self._block += nblocks
        flat = blocks.reshape(-1)
        if self._carry:
            flat = np.concatenate([np.frombuffer(self._carry, np.uint8), flat])
        self._carry = flat[nbytes:].tobytes()
        return np.ascontiguousarray(flat[:nbytes]).view("<u4")


def _ctr_blocks(seed: bytes, block0: int, nblocks: int) -> np.ndarray:
    """(nblocks, RATE) uint8 of ctr-mode output."""
    if nblocks == 0:
        return np.zeros((0, RATE), np.uint8)
    return _native.ctr_expand(seed, block0, nblocks)


def expand_seed(
    rows: int, cols: int, seed: bytes, mode: str = "stream",
    stats: dict | None = None,
) -> np.ndarray:
    """Full (rows, cols) uint32 matrix A.

    stream mode reads the XOF row-major (reference matrix.rs:541-558);
    ctr mode is fingerprint-major: A[r, c] = word[c * rows + r].

    stats (optional) receives alloc_s/xof_s for the native stream path,
    separating buffer-fill cost (kernel page charging, which degrades in
    long-lived processes) from sponge compute."""
    if mode == "stream":
        import time as _t

        t0 = _t.perf_counter()
        out = _native.alloc_array((rows * cols * 4,), np.uint8, nothp=True)
        t1 = _t.perf_counter()
        stream = _native.XofStream(seed)
        stream.squeeze_into(out)
        if stats is not None:
            stats["alloc_s"] = round(t1 - t0, 2)
            stats["xof_s"] = round(_t.perf_counter() - t1, 2)
        return out.view("<u4").reshape(rows, cols)
    words = SeedStream(seed, mode).read_u32(rows * cols)
    if mode == "ctr":
        return np.ascontiguousarray(words.reshape(cols, rows).T)
    return words.reshape(rows, cols)


def expand_fp_block(
    rows: int, col0: int, ncols: int, seed: bytes
) -> np.ndarray:
    """(ncols, rows) uint32 slab of ctr-mode A covering fingerprint columns
    [col0, col0+ncols): slab[j] = A[:, col0+j]. A contiguous ctr word
    range, so any shard/chunk generates exactly its own slice."""
    word0 = col0 * rows
    blk0, rem = divmod(word0 * 4, RATE)
    nwords = ncols * rows
    nblocks = -(-(rem + nwords * 4) // RATE)
    flat = _ctr_blocks(seed, blk0, nblocks).reshape(-1)
    words = np.ascontiguousarray(flat[rem : rem + nwords * 4]).view("<u4")
    return words.reshape(ncols, rows)


def iter_row_blocks(
    rows: int, cols: int, seed: bytes, block_rows: int, mode: str = "stream"
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (row_offset, (r, cols) uint32 block) covering A in order.

    ctr mode is fingerprint-major, so an LWE-row block is strided in the
    stream; this oracle-path helper just materialises A once and slices
    (device paths use fingerprint-range slabs instead)."""
    if mode == "ctr":
        a = expand_seed(rows, cols, seed, mode=mode)
        for r0 in range(0, rows, block_rows):
            yield r0, a[r0 : r0 + block_rows]
        return
    stream = SeedStream(seed, mode)
    for r0 in range(0, rows, block_rows):
        r = min(block_rows, rows - r0)
        yield r0, stream.read_u32(r * cols).reshape(r, cols)


def prefetch_iter(it: Iterator, depth: int = 2, stats: dict | None = None) -> Iterator:
    """Run a (host-bound) iterator in a background thread, `depth` items
    ahead. The XOF squeeze is C code that releases the GIL, so the next A
    row block is squeezed while the device folds the current one into the
    hint — host PRG and device matmul overlap instead of serialising.

    stats (optional) receives {"producer_cpu_s": ...} when the producer
    finishes — the XOF thread's CPU seconds, consumed by the setup
    attribution so PRG cost is not conflated with transfer cost.

    Abandoning the generator early (consumer raises / GeneratorExit) stops
    the producer and reaps the thread — otherwise it would block forever
    on the bounded queue, pinning itself and its buffered blocks."""
    import queue
    import threading
    import time as _time

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def worker():
        cpu0 = _time.thread_time()
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            stop_item = _END
        except BaseException as e:  # surface errors on the consumer side
            stop_item = e
        finally:
            if stats is not None:
                stats["producer_cpu_s"] = _time.thread_time() - cpu0
        while not stop.is_set():
            try:
                q.put(stop_item, timeout=0.1)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)
