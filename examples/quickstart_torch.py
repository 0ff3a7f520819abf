"""Runnable quickstart of the PyTorch/CUDA port: the full PIR protocol on a
small database through chalametpir_tpu_torch.

    python examples/quickstart_torch.py [--entries 2000] [--prg-mode ctr]
        [--device cuda] [--backend auto]

--device cuda (the default) runs the hand-written kernels and fails
without a CUDA device; --device cpu runs their plain versions. --backend
numpy serves from the host oracle (uint64 numpy matmuls; the client still
runs on --device). The times printed are host wall clock around each call.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--entries", type=int, default=2000)
    ap.add_argument("--prg-mode", default="ctr", choices=("ctr", "stream"),
                    help="ctr = A generated on the device; stream = reference-interop")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="auto", choices=("auto", "torch", "numpy"),
                    help="the server's backend: torch (also auto) on --device, numpy = the host oracle")
    ap.add_argument("--pool", type=int, default=4, help="FrodoPIR offline query preprocessing depth")
    args = ap.parse_args(argv)

    import numpy as np

    from chalametpir_tpu_torch import ArithmeticOverflowAddingQueryIndicator, Client, Server
    from chalametpir_tpu_torch.utils import generate_random_kv_database

    rng = np.random.default_rng()
    db = generate_random_kv_database(args.entries, rng=rng)
    seed = rng.bytes(32)

    t0 = time.perf_counter()
    server, hint, filter_params = Server.setup(
        seed, db, arity=3, prg_mode=args.prg_mode, rng=rng, device=args.device,
        backend=args.backend,
    )
    print(f"server setup: {time.perf_counter()-t0:.2f}s ({args.entries} entries, "
          f"b={server.mat_elem_bit_len}, {server.backend} backend, {server.layout} layout, "
          f"on {server.device})")

    t0 = time.perf_counter()
    client = Client.setup(seed, hint, filter_params, prg_mode=args.prg_mode,
                          device=args.device, prepared_queries=args.pool)
    print(f"client setup: {time.perf_counter()-t0:.2f}s "
          f"({client.setup_stats['engine']} engine, pool={args.pool})")

    for key in list(db)[:3]:
        t0 = time.perf_counter()
        while True:
            try:
                query = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                continue  # protocol-legitimate retry, ~arity/2^b odds
        t_q = time.perf_counter() - t0
        t0 = time.perf_counter()
        response = server.respond(query)
        t_r = time.perf_counter() - t0
        t0 = time.perf_counter()
        value = client.process_response(key, response)
        t_p = time.perf_counter() - t0
        if value != db[key]:
            raise SystemExit(f"key {key[:8].hex()}: decoded a wrong value")
        print(f"key {key[:8].hex()}…: query {t_q*1e3:.2f} ms, "
              f"respond {t_r*1e3:.2f} ms, decode {t_p*1e6:.0f} us -> "
              f"{len(value)} B value OK")
    print("quickstart OK")


if __name__ == "__main__":
    main()
