"""The PIR client with its s . A engine on a torch device or on the host.

The port's own client: the host protocol of the JAX package's client
(chalametpir_tpu/models/client.py) copied, not inherited — query,
query_inline, query_batch and process_response, the pending-query
reservation and compare-and-pop, FrodoPIR's prepared-query pool and its
refill thread, save/load and the ternary sampling — with its wire bytes
and its concurrency contract unchanged, on the port's own native engine.
The constructor is the JAX client's: a device engine, or with none the
host engine (`HostQueryEngine`), which computes s . A from a host copy
of A (`pub_mat_a`) with the native ternary matvec. setup builds the same
engines as the JAX client's setup: `device=False` (and "auto" on a
machine without CUDA) the host engine, with A expanded on the host by
core/prg.py; a torch device one of the port's device engines on it. In
ctr mode A is generated on the device by the ctr Keccak kernel, and the
engine is chosen by the JAX client's rule, with the same constant, so
both packages pick the same engine: resident A planes (4 * m *
LWE_DIMENSION bytes) up to RESIDENT_PLANES_MAX_BYTES, the streaming
engine past it. In stream mode (the default, the reference's serial XOF)
the host XOF expands A row block by row block into resident planes on
the device, as the JAX client does.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import hashing, matrix_io, prg
from ..core.filter import BinaryFuseFilter, hash_batch
from ..device import resolve_device
from ..errors import (
    ArithmeticOverflowAddingQueryIndicator,
    DecodedRowNotPrependedWithDigestOfKey,
    InvalidHintMatrix,
    InvalidResponseVector,
    KVDatabaseSizeTooLarge,
    PendingQueryDoesNotExistForKey,
    PendingQueryExistsForKey,
    RowNotDecodable,
)
from ..native import engine as _native
from ..ops.client_device import STREAM_A_BLOCK_ROWS, DeviceQueryEngine, HostQueryEngine, StreamingQueryEngine
from ..params import LWE_DIMENSION, SEED_BYTE_LEN, SERVER_SETUP_MAX_ATTEMPT_COUNT, query_indicator
from ..utils import telemetry

# resident client A planes (4 int8 byte planes, 4 * m * 1774 B) switch to
# the streaming engine past this budget: the JAX client's value (set for a
# 16 GB TPU, where the serving DB usually co-tenants), so both packages
# pick the same engine
RESIDENT_PLANES_MAX_BYTES = 8 << 30


def _timed_blocks(blocks, stats: dict):
    """`blocks`, with the wall seconds spent producing them added up in
    stats["xof_s"]: run it in the producer thread (inside prefetch_iter)
    and that is the time inside the XOF, whatever the consumer does."""
    stats["xof_s"] = 0.0
    it = iter(blocks)
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        stats["xof_s"] += time.perf_counter() - t0
        if item is None:
            return
        yield item


def uses_streaming(m: int) -> bool:
    """The engine rule: stream A once its resident planes would pass
    RESIDENT_PLANES_MAX_BYTES."""
    return 4 * m * LWE_DIMENSION > RESIDENT_PLANES_MAX_BYTES


def _device_engine(seed: bytes, m: int, prg_mode: str, device: torch.device):
    """(engine, its setup_stats["engine"] name, A's expansion stats) of a
    device client. ctr mode: A from the ctr Keccak kernel, resident or
    streamed by `uses_streaming`. Stream mode: the host XOF's row blocks
    from a producer thread into resident planes."""
    if prg_mode == "ctr":
        if uses_streaming(m):
            return StreamingQueryEngine(seed, m, device=device), "streaming", {}
        return DeviceQueryEngine.from_seed_ctr(seed, m, device=device), "resident", {}
    t0 = time.perf_counter()
    xof: dict = {}
    with contextlib.closing(prg.prefetch_iter(
        _timed_blocks(prg.iter_row_blocks(LWE_DIMENSION, m, seed, STREAM_A_BLOCK_ROWS, mode="stream"), xof),
        stats=xof,
    )) as blocks:
        engine = DeviceQueryEngine.from_host_rows(blocks, m, device, stats=xof)
    # the JAX client expands A in one call, whose stats split the buffer's
    # allocation (alloc_s) from the sponge (xof_s). Here A comes block by
    # block from a producer thread into planes on the device: xof_s is the
    # producer's wall inside the XOF squeezes (its blocks' host buffers
    # included), alloc_s the allocation of the device plane buffer
    return engine, "resident", {"a_expand_s": round(time.perf_counter() - t0, 2),
                                "xof_cpu_s": round(xof.get("producer_cpu_s", 0.0), 2),
                                "xof_s": round(xof.get("xof_s", 0.0), 2),
                                "alloc_s": round(xof.get("alloc_s", 0.0), 2)}


@dataclass
class Query:
    """Pending-query state: the secret unblinding vector c = s . M
    (reference: client.rs:13-15). c_ptr caches the raw data address so
    the native response path never touches arr.ctypes on the hot path."""

    vec_c: np.ndarray
    c_ptr: int = 0

    def __post_init__(self):
        if not self.c_ptr:
            vec = np.ascontiguousarray(self.vec_c, np.uint32)
            if vec is not self.vec_c:
                self.vec_c = vec
            self.c_ptr = vec.ctypes.data


class Client:
    def __init__(self, pub_mat_a: np.ndarray | None, hint_mat_m: np.ndarray, filt: BinaryFuseFilter,
                 device_engine=None, seed: bytes | None = None, prg_mode: str = "stream"):
        # the s . A engine (ops/client_device.py); with none, the host engine
        self._engine = device_engine if device_engine is not None else HostQueryEngine(pub_mat_a)
        self._hint_mat_m = hint_mat_m
        self._filter = filt
        self._seed = seed  # retained for save(); public protocol material
        self._prg_mode = prg_mode
        self._pending: dict[bytes, Query] = {}
        # guards compare-and-pop on _pending (reservation itself is a
        # GIL-atomic setdefault and needs no lock)
        self._pending_mutex = threading.Lock()
        # FrodoPIR query preprocessing (ia.cr/2022/981: the (b, c) pair is
        # key-independent, so the paper's client prepares it offline; the
        # reference computes it lazily inside query(), client.rs:106-107).
        # Entries are (query_b = s.A + e, vec_c = s.M).
        self._prepared: list[tuple[np.ndarray, np.ndarray]] = []
        self._prepared_lock = threading.Lock()
        self._refill_target = 0
        self._refill_thread: threading.Thread | None = None
        # reused decode buffer, one per thread: process_response is
        # documented concurrency-safe across distinct keys, and a shared
        # buffer would let thread B's C call overwrite thread A's value
        # between the native return and the .tobytes() copy
        self._resp_out = threading.local()
        # filled by setup(): wall/cpu attribution and the engine chosen
        # (empty when the client was constructed directly)
        self.setup_stats: dict = {}
        # filled by prepare_queries(); phase split of the last batch
        # (host sampling/unblinding vs residual device wait vs b readback)
        self.prepare_stats: dict = {}

    @classmethod
    def setup(
        cls,
        seed: bytes,
        hint_bytes: bytes,
        filter_param_bytes: bytes,
        prg_mode: str = "stream",
        device="cuda",
        prepared_queries: int = 0,
        auto_refill: bool = False,
    ) -> "Client":
        """Regenerate A from the seed and parse the hint. `device` says where
        A lives and s . A runs: False is the JAX client's host engine (A
        expanded on the host, s . A in the native ternary matvec, no torch
        tensor); "auto" is that engine on a machine without CUDA and
        "cuda" with it; "cuda" or True the kernels (AcceleratorError
        without CUDA); "cpu" the device engine on the plain versions, for
        the tests. The choice is made once, before any work, and nothing
        falls back. `prg_mode` must match the server's. In ctr mode, past
        RESIDENT_PLANES_MAX_BYTES of A planes the device client streams A
        per batch (`uses_streaming`). In stream mode the host XOF's A
        passes the PIR_CLIENT_MAX_A_BYTES cap (KVDatabaseSizeTooLarge), as
        in the JAX client, and lands in resident planes or in host memory.
        A failure to build the engine raises."""
        if len(seed) != SEED_BYTE_LEN:
            raise ValueError(f"seed must be {SEED_BYTE_LEN} bytes")
        if prg_mode not in prg.PRG_MODES:
            raise ValueError(f"unknown prg mode {prg_mode!r}")
        # identity, not ==: 0 and torch.device("cpu") are not the JAX False
        on_host = device is False or (isinstance(device, str) and device == "auto"
                                      and not torch.cuda.is_available())
        if not on_host:
            device = resolve_device(device)
        wall0, cpu0 = time.perf_counter(), time.thread_time()
        ru0 = telemetry.thread_rusage()
        filt = BinaryFuseFilter.from_bytes(filter_param_bytes)
        hint_mat_m = matrix_io.matrix_from_bytes(hint_bytes)
        if hint_mat_m.shape[0] != LWE_DIMENSION:
            raise InvalidHintMatrix()
        m = filt.num_fingerprints
        stats: dict = {}
        if prg_mode == "stream":
            # the filter params come off the wire: bound the expansion they
            # imply (default 64 GiB, past the 2^23-entry DB's ~63 GiB)
            a_bytes = 4 * LWE_DIMENSION * m
            max_a = int(os.environ.get("PIR_CLIENT_MAX_A_BYTES", 1 << 36))
            if a_bytes > max_a:
                raise KVDatabaseSizeTooLarge(
                    f"filter params imply a {a_bytes / 2**30:.0f} GiB matrix-A "
                    f"expansion (> {max_a / 2**30:.0f} GiB cap; raise "
                    "PIR_CLIENT_MAX_A_BYTES or use prg_mode='ctr')"
                )
        if on_host:
            # the JAX client's host engine: A in one host expansion (stream
            # mode: one native XOF squeeze into one buffer, its stats
            # alloc_s / xof_s; ctr mode: the host ctr words,
            # fingerprint-major)
            t0 = time.perf_counter()
            pub_mat_a = prg.expand_seed(LWE_DIMENSION, m, seed, mode=prg_mode, stats=stats)
            stats["a_expand_s"] = round(time.perf_counter() - t0, 2)
            engine, engine_name = HostQueryEngine(pub_mat_a), "host"
        else:
            engine, engine_name, stats = _device_engine(seed, m, prg_mode, device)
        client = cls(None, hint_mat_m, filt, engine, seed, prg_mode)
        # user/sys and the fault count say where a slow setup went: sys- or
        # fault-dominated means kernel memory management, not XOF compute
        ru1 = telemetry.thread_rusage()
        client.setup_stats = {
            **stats,
            "wall_s": round(time.perf_counter() - wall0, 2),
            "cpu_s": round(time.thread_time() - cpu0, 2),
            "sys_s": round(ru1.ru_stime - ru0.ru_stime, 2),
            "minflt": ru1.ru_minflt - ru0.ru_minflt,
            "engine": engine_name,
            "plane_bytes": engine.device_bytes,
        }
        if prepared_queries > 0:
            client.prepare_queries(prepared_queries)
        if auto_refill:
            client._refill_target = max(prepared_queries, 1)
        return client

    def prepare_queries(self, count: int) -> None:
        """FrodoPIR offline query preprocessing (ia.cr/2022/981): compute
        `count` key-independent (b = s.A + e, c = s.M) pairs and pool them.
        All `count` secrets ride one batched matvec, so A streams from
        device memory once per batch; the host-side error sampling and s.M
        unblinding matvecs overlap the device dot and readback (the host
        engine's matvec runs after them)."""
        self._prepare_queries(count, record_stats=True)

    def _prepare_queries(self, count: int, record_stats: bool) -> None:
        """prepare_queries body; the background refill passes
        record_stats=False so it cannot clobber a foreground caller's
        prepare_stats attribution from another thread."""
        if count <= 0:
            return
        m = self._filter.num_fingerprints
        t0 = time.perf_counter()
        secrets = np.stack([self._sample_ternary(LWE_DIMENSION) for _ in range(count)])
        pending = self._engine.matvec_batch_async(secrets)
        errors = [self._sample_ternary(m) for _ in range(count)]
        vec_cs = [_native.ternary_matvec(secrets[i], self._hint_mat_m) for i in range(count)]
        stats: dict = {"host_s": round(time.perf_counter() - t0, 3)}
        b_batch = np.ascontiguousarray(pending.read(stats)[:, :m])
        for i in range(count):
            _native.add_ternary_u32(b_batch[i], errors[i])
        entries = [(b_batch[i], vec_cs[i]) for i in range(count)]
        stats["count"] = count
        stats["wall_s"] = round(time.perf_counter() - t0, 3)
        if record_stats:
            self.prepare_stats = stats
        with self._prepared_lock:
            self._prepared.extend(entries)

    def stop_refill(self, join: bool = True, timeout: float | None = 30.0) -> None:
        """Quiesce the background auto-refill: clear the target (the loop
        exits after its current batch) and optionally join the thread.
        Call before interpreter exit in long-lived processes — a daemon
        thread terminated mid native or device call at CPython finalization is
        a known crash/hang class."""
        self._refill_target = 0
        t = self._refill_thread
        if join and t is not None and t.is_alive():
            t.join(timeout=timeout)

    @property
    def prepared_query_count(self) -> int:
        with self._prepared_lock:
            return len(self._prepared)

    def _pop_prepared(self):
        with self._prepared_lock:
            entry = self._prepared.pop() if self._prepared else None
            self._maybe_spawn_refill_locked()
        return entry

    def _maybe_spawn_refill_locked(self) -> None:
        """Start the background refill thread when the pool is below
        target. MUST be called with _prepared_lock held: two concurrent
        poppers must not each start a refill thread (duplicate threads
        both compute `need` before either lands, overshooting the pool);
        start() inside the lock also means a concurrent popper can never
        observe a created-but-not-started (is_alive()==False) thread —
        the child blocks on the lock until this frame releases it."""
        if (
            self._refill_target
            and len(self._prepared) < self._refill_target
            and (self._refill_thread is None or not self._refill_thread.is_alive())
        ):
            self._refill_thread = threading.Thread(
                target=self._refill_loop, daemon=True
            )
            self._refill_thread.start()

    def _refill_loop(self) -> None:
        """Top the pool back up to the target, re-checking after each batch
        so pops that happen mid-refill are also covered.

        The exit decision clears _refill_thread under the SAME lock the
        spawn check takes: a popper either sees need observed by this
        loop (which then continues) or sees _refill_thread already
        cleared (and spawns). With the exit decided outside the lock, a
        popper could observe the exiting thread as still alive, skip the
        spawn, and leave the pool below target until the next pop."""
        while True:
            with self._prepared_lock:
                need = self._refill_target - len(self._prepared)
                if need <= 0:
                    self._refill_thread = None
                    return
            self._prepare_queries(need, record_stats=False)

    # -- query ---------------------------------------------------------------

    def _reserve_pending(self, key: bytes) -> object:
        """Atomically claim `key` in _pending with a unique token, or
        raise PendingQueryExistsForKey. dict.setdefault is GIL-atomic,
        and the token is unique per call, so of two threads querying the
        same key exactly one wins — the old `key in self._pending`
        check-then-act let both pass, and the second insert silently
        overwrote the first Query's unblinding vector (undecodable
        responses instead of the typed error). The token reads as
        "no pending query" to process_response/save (isinstance(Query)
        checks) until the query finalizes."""
        token = object()
        if self._pending.setdefault(key, token) is not token:
            raise PendingQueryExistsForKey()
        return token

    def _pop_pending_if(self, key: bytes, expected: object) -> bool:
        """Atomically remove _pending[key] only if it is still `expected`
        (a get-then-pop would let a concurrent consume + re-query land a
        NEW entry between the two ops and destroy it)."""
        with self._pending_mutex:
            if self._pending.get(key) is expected:
                del self._pending[key]
                return True
            return False

    def _release_reservation(self, key: bytes, token: object) -> None:
        """Drop a reservation that never finalized (failure paths only).
        Only removes OUR token: finalize replaced it with the real Query
        on success, and no other thread can hold this token."""
        self._pop_pending_if(key, token)

    def query(self, key: bytes) -> bytes:
        """Build an encrypted query for `key`
        (reference: client.rs:84-194). Raises
        ArithmeticOverflowAddingQueryIndicator occasionally; callers retry
        (the fresh secret makes the retry independent).

        When the preprocessing pool has entries (see prepare_queries),
        the online cost is just the indicator add + serialization; the
        expensive s.A matvec happened offline. An entry consumed by a
        query that overflows is discarded, preserving the reference's
        fresh-randomness retry contract."""
        key = bytes(key)
        with telemetry.span("client.query"):
            token = self._reserve_pending(key)
            try:
                entry = self._pop_prepared()
                if entry is not None:
                    return self._finalize_prepared(key, entry)
                return self._query_inline_reserved(key)
            except BaseException:
                self._release_reservation(key, token)
                raise

    def query_inline(self, key: bytes) -> bytes:
        """query() but always computing s.A inline (never from the
        preprocessing pool) — the reference's lazy evaluation order."""
        key = bytes(key)
        with telemetry.span("client.query"):
            token = self._reserve_pending(key)
            try:
                return self._query_inline_reserved(key)
            except BaseException:
                self._release_reservation(key, token)
                raise

    def _query_inline_reserved(self, key: bytes) -> bytes:
        """Inline s.A for a key the caller has already reserved."""
        with telemetry.span("client.query.secret"):
            secret_s = self._sample_ternary(LWE_DIMENSION)
        # dispatch s.A, overlap the host-side error sampling and unblinding
        # matvec with the device dot + readback (the host engine computes
        # it when it is read)
        with telemetry.span("client.query.launch", fused=self._engine.fused_launches(1)):
            b_base = self._engine.matvec_batch_async(secret_s[None, :])
        return self._finalize_query(key, secret_s, b_base)

    def _add_query_indicator(self, query_b: np.ndarray, key: bytes) -> None:
        """Add Δ = ⌊2^32/2^b⌋ at the key's filter rows, in place
        (reference: client.rs:109-134). Raises the overflow error; every
        caller discards query_b and retries with fresh randomness, so
        partial mutation is unobservable."""
        digest = hashing.hash_of_key(key)
        fused = int(hashing.mix256(digest, self._filter.seed))
        rows = hash_batch(
            self._filter.arity,
            np.uint64(fused),
            self._filter.segment_length,
            self._filter.segment_count_length,
        )
        delta = query_indicator(self._filter.mat_elem_bit_len)
        for r in rows:
            r = int(r)
            total = int(query_b[r]) + delta
            if total > 0xFFFFFFFF:
                raise ArithmeticOverflowAddingQueryIndicator()
            query_b[r] = total

    def _finalize_prepared(self, key: bytes, entry) -> bytes:
        """Online phase over a preprocessed (b, c) pair: add the query
        indicator and record the pending unblinding vector. The entry is
        consumed either way; on overflow the caller retries and a fresh
        entry (or the inline path) supplies fresh randomness."""
        query_b, vec_c = entry
        with telemetry.span("client.query.indicator"):
            self._add_query_indicator(query_b, key)
        self._pending[key] = Query(vec_c=vec_c)
        with telemetry.span("client.query.serialize"):
            return matrix_io.matrix_to_bytes(query_b[None, :])

    def query_batch(self, keys: list[bytes]) -> list[bytes]:
        """Build queries for several keys at once. Preprocessed pool
        entries are used first; the remainder ride one batched matvec
        (A streams from device memory once per batch instead of once per
        key). Keys
        whose indicator overflows are transparently retried with fresh
        randomness — bounded like the filter-construction retry loop
        (params.rs:10); the per-retry overflow odds are ~arity/2^b, so the
        cap is unreachable except under a logic bug, which then surfaces
        as the error instead of a hang.

        Pool interaction contract: exactly min(len(keys), pool depth)
        prepared entries are consumed, decided once up front; overflow
        retries always recompute inline and NEVER dip back into the pool
        (so a concurrent auto_refill can't be silently drained mid-batch
        and the pool cost of a batch is deterministic)."""
        keys = [bytes(k) for k in keys]
        if len(set(keys)) != len(keys):
            raise PendingQueryExistsForKey()
        with telemetry.span("client.query", queries=len(keys)):
            tokens: dict[bytes, object] = {}
            try:
                for key in keys:
                    tokens[key] = self._reserve_pending(key)
            except PendingQueryExistsForKey:
                for k, t in tokens.items():
                    self._release_reservation(k, t)
                raise

            # everything from here runs with the keys reserved, so the unwind
            # below must cover it ALL — a sampling/engine failure outside the
            # try would leak the reservations and leave the keys permanently
            # unqueryable for this client's lifetime
            out = []
            try:
                n_pool_target = len(keys)
                pool_entries = []
                with self._prepared_lock:
                    while self._prepared and len(pool_entries) < n_pool_target:
                        pool_entries.append(self._prepared.pop())
                    self._maybe_spawn_refill_locked()
                fresh_keys = keys[len(pool_entries) :]
                if fresh_keys:
                    with telemetry.span("client.query.secret"):
                        codes = np.stack(
                            [self._sample_ternary(LWE_DIMENSION) for _ in fresh_keys]
                        )
                    with telemetry.span("client.query.launch", fused=self._engine.fused_launches(len(fresh_keys))):
                        # dispatch without waiting and hand each key its (1,
                        # m_pad) row: _finalize_query runs the host-side work
                        # (error sampling, the s . M matvec) BEFORE
                        # materialising it, overlapping the device dot +
                        # readback like the inline and prepare paths do
                        b_dev = self._engine.matvec_batch_async(codes)
                        b_batch = [b_dev[j : j + 1] for j in range(len(fresh_keys))]
                for i, key in enumerate(keys):
                    try:
                        if i < len(pool_entries):
                            out.append(self._finalize_prepared(key, pool_entries[i]))
                        else:
                            j = i - len(pool_entries)
                            out.append(self._finalize_query(key, codes[j], b_batch[j]))
                    except ArithmeticOverflowAddingQueryIndicator:
                        for attempt in range(SERVER_SETUP_MAX_ATTEMPT_COUNT):
                            try:
                                # the key is still reserved by this batch (the
                                # overflow raise left the token in place)
                                out.append(self._query_inline_reserved(key))
                                break
                            except ArithmeticOverflowAddingQueryIndicator:
                                continue
                        else:
                            raise
            except BaseException:
                # a key exhausted the retry cap (or anything else blew up):
                # the caller never receives `out`, so keys finalized earlier
                # in this batch would be stuck pending with their query bytes
                # lost, and unfinalized keys still hold reservations. Unwind
                # both so the whole batch can simply be retried. (Consumed
                # pool entries stay consumed — that is the documented
                # contract.)
                for k in keys:
                    self._pending.pop(k, None)
                raise
            return out

    def _finalize_query(self, key: bytes, secret_s: np.ndarray, b_base) -> bytes:
        """Add the error vector and the query indicator, record the
        pending unblinding vector (reference: client.rs:106-139). Raises
        the overflow error with no state change; callers retry with a
        fresh secret.

        b_base is an engine's (1, m_pad) result from matvec_batch_async,
        still in flight: all host-only work (error sampling, the s.M
        matvec, key hashing) runs before it is materialised, so it
        overlaps the device dot and readback."""
        m = self._filter.num_fingerprints
        with telemetry.span("client.query.error"):
            error_e = self._sample_ternary(m)
        with telemetry.span("client.query.unblind"):
            vec_c = _native.ternary_matvec(secret_s, self._hint_mat_m)

        with telemetry.span("client.query.wait") as wait:
            b_host = np.asarray(b_base)
            wait.set(bytes=b_host.nbytes)
        # b_host is this call's own array (a device row's fresh host copy or
        # the host engine's matvec output), so the error goes in in place
        query_b = b_host[0, :m]
        with telemetry.span("client.query.indicator"):
            _native.add_ternary_u32(query_b, error_e)
            self._add_query_indicator(query_b, key)

        self._pending[key] = Query(vec_c=vec_c)
        with telemetry.span("client.query.serialize"):
            return matrix_io.matrix_to_bytes(query_b[None, :])

    # -- response ------------------------------------------------------------

    def process_response(self, key: bytes, response_bytes: bytes) -> bytes:
        """Decrypt, round, unmask, decode, and verify the digest prefix
        (reference: client.rs:209-275)."""
        key = bytes(key)
        pending = self._pending.get(key)
        # a reservation token (query() still in flight on another thread)
        # reads as "no pending query": the caller cannot have its bytes yet
        if not isinstance(pending, Query):
            raise PendingQueryDoesNotExistForKey()

        b = self._filter.mat_elem_bit_len

        # single native crossing, wire bytes straight in: header parse,
        # hash, fold, decrypt, decode, digest check all in C (the
        # multi-call path costs ~5x in dispatch alone)
        cols = pending.vec_c.shape[0]
        out_len = (cols * b) // 8 + 1
        out = getattr(self._resp_out, "buf", None)
        if out is None or out.shape[0] < out_len:
            out = self._resp_out.buf = np.empty(out_len, np.uint8)
        with telemetry.span("client.process_response"):
            result = _native.client_process_response_wire(
                key, self._filter.seed, response_bytes,
                pending.c_ptr, cols, b, out.ctypes.data,
            )
        if result == -3:
            # malformed response: the pending query survives, exactly
            # like the reference's early-return (client.rs:210-217)
            raise InvalidResponseVector()
        if not self._pop_pending_if(key, pending):
            # a concurrent same-key process_response consumed the
            # entry first (and a new query may even have re-landed at
            # this key — never pop THAT one); get-then-del used to
            # raise a bare KeyError here
            raise PendingQueryDoesNotExistForKey()
        if result == -1:
            raise RowNotDecodable()
        if result == -2:
            raise DecodedRowNotPrependedWithDigestOfKey()
        return out[32 : 32 + result].tobytes()

    # -- persistence -----------------------------------------------------------
    #
    # Counterpart of Server.save/load (the reference has no client
    # persistence; its wire formats are the only state transfer,
    # SURVEY.md section 5). A restarted client process resumes with its
    # pending queries intact; the preprocessed pool is deliberately NOT
    # persisted (see save() for the query-privacy argument) and refills
    # fresh after load.

    def save(self, path: str) -> None:
        """Persist the client state: setup material + pending queries.
        The archive contains SECRET material — the pending unblinding
        vectors are LWE secrets; protect the file like a key.

        The preprocessed query pool is deliberately NOT persisted: pool
        entries are one-time LWE encryptions whose (s.A + e) half goes on
        the wire when consumed. Restoring a pool snapshot after any entry
        was consumed would send the same randomness for two different
        keys, and the difference of the two query vectors hands the
        server the filter rows of both — a query-privacy break. Pending
        vec_c values never leave the client, so restoring those is safe
        (the worst a stale archive yields is a failed decode)."""
        if self._seed is None:
            raise ValueError("client was constructed without a seed; cannot save")
        # one atomic snapshot of the pending dict: a concurrent
        # process_response() popping a key between "list the keys" and
        # "read each entry" must not KeyError the save. Reservation
        # tokens (queries still in flight on other threads) are skipped —
        # their callers have no query bytes yet, so there is nothing to
        # resume
        pending = {
            k: v for k, v in dict(self._pending).items()
            if isinstance(v, Query)
        }
        pend_keys = list(pending.keys())
        arrays = dict(
            hint=self._hint_mat_m,
            fparams=np.frombuffer(self._filter.to_bytes(), np.uint8),
            seed=np.frombuffer(self._seed, np.uint8),
            prg_mode=np.array([self._prg_mode]),
            key_blob=np.frombuffer(b"".join(pend_keys) or b"\0", np.uint8),
            key_lens=np.array([len(k) for k in pend_keys], np.int64),
        )
        if pend_keys:
            arrays["pending_c"] = np.stack(
                [pending[k].vec_c for k in pend_keys]
            )
        # the archive holds LWE secret material: owner-only (0600) BEFORE
        # any bytes land. The os.open mode only applies on creation, so an
        # archive that already exists with looser permissions is fchmod'd
        # too. Write through a file handle — np.savez(str) appends ".npz"
        # to suffix-less paths, which load() would then fail to find.
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.fchmod(fd, 0o600)
        except OSError:  # pragma: no cover - non-POSIX filesystems
            pass
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path: str, device="cuda") -> "Client":
        """Rebuild a client from a save() archive (either package's: the
        format is the JAX client's): set up again on `device` with the
        archive's seed, hint, filter params and prg mode, then restore the
        pending queries. A is regenerated from the stored (public) seed."""
        with np.load(path) as archive:
            hint_bytes = matrix_io.matrix_to_bytes(archive["hint"])
            fparams = archive["fparams"].tobytes()
            seed = archive["seed"].tobytes()
            prg_mode = str(archive["prg_mode"][0])
            client = cls.setup(seed, hint_bytes, fparams, prg_mode=prg_mode, device=device)
            blob = archive["key_blob"].tobytes()
            # one archive read: NpzFile re-decompresses the whole stack on
            # every __getitem__, which would make restore O(P^2) in
            # pending-query count
            key_lens = archive["key_lens"]
            pending_c = archive["pending_c"] if len(key_lens) else ()
            off = 0
            for i, ln in enumerate(key_lens):
                key = blob[off : off + int(ln)]
                off += int(ln)
                client._pending[key] = Query(vec_c=pending_c[i].copy())
        return client

    # -- benchmarking hooks (reference: client.rs:60-71) -----------------------

    def discard_query(self, key: bytes) -> Query | None:
        """Remove and return the pending query of `key`, or None when there
        is none. A reservation (a query() for this key still in flight on
        another thread) stays where it is and reads as none."""
        key = bytes(key)
        with self._pending_mutex:
            pending = self._pending.get(key)
            if not isinstance(pending, Query):
                return None
            del self._pending[key]
            return pending

    def insert_query(self, key: bytes, query: Query) -> None:
        """Install `query` as the pending query of `key` (what discard_query
        returned), replacing whatever is there."""
        with self._pending_mutex:
            self._pending[bytes(key)] = query

    @staticmethod
    def _sample_ternary(n: int) -> np.ndarray:
        """Uniform {0, 1, -1} as {0, 1, 2} codes from a CSPRNG — these are
        LWE encryption secrets, so a statistical RNG is not acceptable
        (reference samples from OS-entropy-keyed ChaCha8,
        matrix.rs:572-619; -1 is u32::MAX on the wire)."""
        return _native.chacha8_ternary(os.urandom(32), n)

    @property
    def uses_device(self) -> bool:
        """True when s . A runs in an engine on a torch device; False for
        the host engine (the constructor with no engine, or
        setup(device=False))."""
        return self._engine.uses_device
