"""Phase-level profile of server setup at the headline configuration.

    python -m chalametpir_tpu_torch.diag.profile_setup [LOG_N] [ARITY]
        [--prg-mode ctr] [--device cuda]

Counterpart of scripts/profile_setup.py. Builds 2^LOG_N (default 20)
entries of 32-byte keys and 1 kB values, then times on the host's clock,
one line each on stderr:

* the host phases on their own, in the order setup runs them: hashing the
  keys, building the filter, the fused encode (the whole of D), packing D
  and copying its planes to the device;
* `Server.setup` itself through the public entry point, with tracing on,
  so that every telemetry span of the setup prints its own `[trace]` line,
  then the setup's `setup_stats`: `phases_s` (where the main thread's wall
  went), `cpu_s` (wall = main + worker or producer + runtime + external)
  and the rest;
* one `respond_batch`, Q = 1 and Q = 64, on the host's clock (the query
  upload and the readback included).

Needs the native engine (built on first use) and, with --device cuda, a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

VALUE_LEN = 1024


def tick(label: str, t0: float) -> float:
    t1 = time.perf_counter()
    print(f"[profile] {label}: {t1 - t0:.2f}s", file=sys.stderr, flush=True)
    return t1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_n", nargs="?", type=int, default=20)
    ap.add_argument("arity", nargs="?", type=int, default=3, choices=(3, 4))
    ap.add_argument("--prg-mode", default="ctr", choices=("ctr", "stream"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from chalametpir_tpu_torch import Server
    from chalametpir_tpu_torch.core import codec, hashing
    from chalametpir_tpu_torch.core.filter import construct_filter
    from chalametpir_tpu_torch.device import resolve_device
    from chalametpir_tpu_torch.native import engine as native
    from chalametpir_tpu_torch.ops import respond_packed
    from chalametpir_tpu_torch.params import SERVER_SETUP_MAX_ATTEMPT_COUNT, find_mat_elem_bit_len
    from chalametpir_tpu_torch.utils import telemetry

    device = resolve_device(args.device)
    n = 1 << args.log_n
    rng = np.random.default_rng(0xBEEF)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    keys_buf = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    vals_buf = rng.integers(0, 256, size=n * VALUE_LEN, dtype=np.uint8).tobytes()
    keys = [keys_buf[i].tobytes() for i in range(n)]
    values = [vals_buf[i * VALUE_LEN : (i + 1) * VALUE_LEN] for i in range(n)]
    native.build()
    t0 = tick(f"build_db ({n} entries x {VALUE_LEN} B)", t0)

    # the host phases on their own
    bit_len = find_mat_elem_bit_len(n)
    digests = hashing.hash_of_keys_batch(keys)
    t0 = tick(f"hash_keys (b={bit_len})", t0)
    filt, reverse_order, reverse_h, key_index = construct_filter(
        digests, args.arity, bit_len, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng)
    t0 = tick(f"construct_filter (m={filt.num_fingerprints})", t0)
    cols = codec.encoded_row_width(VALUE_LEN, bit_len)
    digest_bytes = np.ascontiguousarray(digests).view(np.uint8).reshape(n, 32)
    mat = native.encode_assemble_rows16(
        digest_bytes, values, key_index, reverse_order, reverse_h, bit_len, cols,
        filt.num_fingerprints, filt.arity, filt.segment_length, filt.segment_count_length,
    )
    t0 = tick(f"encode_assemble_rows16 fused ({mat.nbytes / 1e9:.2f} GB D)", t0)
    planes = respond_packed.build_packed_db(mat, bit_len, device)
    sync()
    t0 = tick(f"build_packed_db (pack + upload, {planes.device_bytes / 1e9:.2f} GB of planes)", t0)
    del mat, planes, digests, digest_bytes, filt, reverse_order, reverse_h, key_index

    # the setup itself, every span traced
    db = dict(zip(keys, values))
    seed = rng.bytes(32)
    if device.type == "cuda":
        from chalametpir_tpu_torch import kernels

        kernels.build()
    t0 = tick("dict + kernel build", t0)
    was = telemetry.trace_enabled()
    telemetry.set_trace(True)
    try:
        server, hint, _ = Server.setup(seed, db, arity=args.arity, prg_mode=args.prg_mode,
                                       rng=rng, device=device)
        sync()
    finally:
        telemetry.set_trace(was)
    t0 = tick(f"Server.setup (prg_mode={args.prg_mode}, hint {len(hint)} B)", t0)
    for key, value in server.setup_stats.items():
        print(f"[profile] setup_stats.{key}: {value}", file=sys.stderr, flush=True)

    for q in (1, 64):
        queries = rng.integers(0, 1 << 32, size=(q, server.num_query_cols), dtype=np.uint32)
        server.respond_batch(queries)
        t0 = time.perf_counter()
        server.respond_batch(queries)
        print(f"[profile] respond_batch Q={q}: {(time.perf_counter() - t0) * 1e3:.2f} ms (host wall, upload "
              "and readback included)", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
