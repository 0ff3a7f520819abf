"""The PIR client with its s . A engine on a torch device.

The client protocol — query, query_batch, process_response, the pending
query reservation, the prepared-query pool and `save` — is the JAX
package's host client, inherited unchanged. Only setup differs: it builds
one of the port's engines and hands it to the base constructor. In ctr
mode A is generated on the device by the ctr Keccak kernel, and the
engine is chosen by the JAX client's rule, read from its module so that
one number rules both packages: resident A planes (4 * m * LWE_DIMENSION
bytes) up to RESIDENT_PLANES_MAX_BYTES, the streaming engine past it. In
stream mode (the default, the reference's serial XOF) the host XOF
expands A row block by row block into resident planes on the device, as
the JAX client does.
"""

from __future__ import annotations

import contextlib
import os
import time

from chalametpir_tpu.core import matrix_io, prg
from chalametpir_tpu.core.filter import BinaryFuseFilter
from chalametpir_tpu.errors import InvalidHintMatrix, KVDatabaseSizeTooLarge
from chalametpir_tpu.models import client as _host
from chalametpir_tpu.params import LWE_DIMENSION, SEED_BYTE_LEN

from ..ops.client_device import DeviceQueryEngine, StreamingQueryEngine
from .server import resolve_device

# A rows per uploaded block in stream mode: the recode writes r-byte runs
# into the fingerprint-major planes, and the host holds two blocks in
# flight (64 x m x 4 bytes each, 302 MB at 2^20 entries)
STREAM_A_BLOCK_ROWS = 64


def uses_streaming(m: int) -> bool:
    """The JAX client's engine rule: stream A once its resident planes
    would pass RESIDENT_PLANES_MAX_BYTES (set for a 16 GB TPU)."""
    return 4 * m * LWE_DIMENSION > _host.RESIDENT_PLANES_MAX_BYTES


class Client(_host.Client):
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
        """Regenerate A from the seed on `device` ("cuda": the kernels,
        AcceleratorError without CUDA; "cpu": the plain versions) and parse
        the hint. `prg_mode` must match the server's. In ctr mode, past
        RESIDENT_PLANES_MAX_BYTES of A planes the client streams A per
        batch (`uses_streaming`). In stream mode the host XOF's A passes
        the JAX client's PIR_CLIENT_MAX_A_BYTES cap (KVDatabaseSizeTooLarge)
        and lands in resident planes. A failure to build the engine
        raises, with no fallback."""
        if prg_mode not in prg.PRG_MODES:
            raise ValueError(f"unknown prg mode {prg_mode!r}")
        if len(seed) != SEED_BYTE_LEN:
            raise ValueError(f"seed must be {SEED_BYTE_LEN} bytes")
        device = resolve_device(device)
        wall0, cpu0 = time.perf_counter(), time.thread_time()
        filt = BinaryFuseFilter.from_bytes(filter_param_bytes)
        hint_mat_m = matrix_io.matrix_from_bytes(hint_bytes)
        if hint_mat_m.shape[0] != LWE_DIMENSION:
            raise InvalidHintMatrix()
        m = filt.num_fingerprints
        stats: dict = {}
        if prg_mode == "ctr":
            streaming = uses_streaming(m)
            if streaming:
                engine = StreamingQueryEngine(seed, m, device)
            else:
                engine = DeviceQueryEngine.from_seed_ctr(seed, m, device)
        else:
            # the filter params come off the wire: bound the expansion they
            # imply, with the JAX client's cap and variable
            a_bytes = 4 * LWE_DIMENSION * m
            max_a = int(os.environ.get("PIR_CLIENT_MAX_A_BYTES", 1 << 36))
            if a_bytes > max_a:
                raise KVDatabaseSizeTooLarge(
                    f"filter params imply a {a_bytes / 2**30:.0f} GiB matrix-A "
                    f"expansion (> {max_a / 2**30:.0f} GiB cap; raise "
                    "PIR_CLIENT_MAX_A_BYTES or use prg_mode='ctr')"
                )
            streaming = False
            t0 = time.perf_counter()
            xof: dict = {}
            with contextlib.closing(prg.prefetch_iter(
                prg.iter_row_blocks(LWE_DIMENSION, m, seed, STREAM_A_BLOCK_ROWS, mode="stream"),
                stats=xof,
            )) as blocks:
                engine = DeviceQueryEngine.from_host_rows(blocks, m, device)
            stats = {"a_expand_s": round(time.perf_counter() - t0, 2),
                     "xof_cpu_s": round(xof.get("producer_cpu_s", 0.0), 2)}
        client = cls(None, hint_mat_m, filt, device_engine=engine, seed=seed, prg_mode=prg_mode)
        client.setup_stats = {
            **stats,
            "wall_s": round(time.perf_counter() - wall0, 2),
            "cpu_s": round(time.thread_time() - cpu0, 2),
            "engine": "streaming" if streaming else "resident",
            "plane_bytes": engine.device_bytes,
        }
        if prepared_queries > 0:
            client.prepare_queries(prepared_queries)
        if auto_refill:
            client._refill_target = max(prepared_queries, 1)
        return client

    @classmethod
    def load(cls, path: str, device="cuda") -> "Client":
        """Rebuild a client from a `save` archive (the JAX package's
        format, either package's archive): set up again on `device` with
        the archive's seed, hint, filter params and prg mode, then restore
        the pending queries. The prepared pool is not persisted, for the
        JAX client's reason (chalametpir_tpu.models.client.Client.save)."""
        return super().load(path, device=device)
