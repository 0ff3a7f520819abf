"""The PIR client with its s . A engine on a torch device.

The client protocol — query, query_batch, process_response, the pending
query reservation and the prepared-query pool — is the JAX package's host
client, inherited unchanged. Only setup differs: it builds one of the
port's engines (A generated on the device by the ctr Keccak kernel) and
hands it to the base constructor. The engine is chosen by the JAX
client's rule, read from its module so that one number rules both
packages: resident A planes (4 * m * LWE_DIMENSION bytes) up to
RESIDENT_PLANES_MAX_BYTES, the streaming engine past it.
"""

from __future__ import annotations

import time

from chalametpir_tpu.core import matrix_io
from chalametpir_tpu.core.filter import BinaryFuseFilter
from chalametpir_tpu.errors import InvalidHintMatrix
from chalametpir_tpu.models import client as _host
from chalametpir_tpu.params import LWE_DIMENSION, SEED_BYTE_LEN

from ..ops.client_device import DeviceQueryEngine, StreamingQueryEngine
from .server import resolve_device


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
        prg_mode: str = "ctr",
        device="cuda",
        prepared_queries: int = 0,
        auto_refill: bool = False,
    ) -> "Client":
        """Regenerate A from the seed on `device` ("cuda": the ctr Keccak
        kernel, AcceleratorError without CUDA; "cpu": the plain versions)
        and parse the hint. `prg_mode` must match the server's; only
        "ctr" is ported. Past RESIDENT_PLANES_MAX_BYTES of A planes the
        client streams A per batch (`uses_streaming`); a failure to build
        the chosen engine raises, with no fallback."""
        if prg_mode != "ctr":
            raise NotImplementedError(
                "only prg_mode='ctr' is ported; the stream-mode ('km') engine is ROADMAP Queue 1 work"
            )
        if len(seed) != SEED_BYTE_LEN:
            raise ValueError(f"seed must be {SEED_BYTE_LEN} bytes")
        device = resolve_device(device)
        wall0, cpu0 = time.perf_counter(), time.thread_time()
        filt = BinaryFuseFilter.from_bytes(filter_param_bytes)
        hint_mat_m = matrix_io.matrix_from_bytes(hint_bytes)
        if hint_mat_m.shape[0] != LWE_DIMENSION:
            raise InvalidHintMatrix()
        m = filt.num_fingerprints
        streaming = uses_streaming(m)
        if streaming:
            engine = StreamingQueryEngine(seed, m, device)
        else:
            engine = DeviceQueryEngine.from_seed_ctr(seed, m, device)
        client = cls(None, hint_mat_m, filt, device_engine=engine, seed=seed, prg_mode=prg_mode)
        client.setup_stats = {
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
        raise NotImplementedError("client persistence is not ported yet (ROADMAP Queue 1)")
