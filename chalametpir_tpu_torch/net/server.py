"""TCP PIR server on the port (reference: chalametpir_server/examples/server.rs).

Run: python -m chalametpir_tpu_torch.net.server [--host 127.0.0.1] [--port 8080]
     [--device cuda] [--prg-mode stream]

Serves the demo fruit database unless --random-db N is given. The
transport is the JAX package's (chalametpir_tpu/net/server.py), imported:
`PirTcpServer` sends each connection the setup artifacts and answers its
length-framed queries through one `BatchDispatcher`, which stacks whatever
queries are queued, from every connection, into one respond_batch call —
one respond kernel launch per batch, run in a worker thread.

The dispatcher pads a batch to its full depth only for a server whose
`_backend` is "jax" (a jitted respond compiles once per batch shape), and
the port's Server has no `_backend`, so it does not pad here: the respond
kernel compiles nothing per shape, and a padded batch would make a lone
query pay for a 64-query scan (6.83 ms against 1.14 ms for one query, on an
NVIDIA H100 80GB HBM3 at a 700 W power limit; PERF.md).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

import numpy as np

from chalametpir_tpu.net.server import (  # noqa: F401  (re-exported)
    DEMO_DB,
    BatchDispatcher,
    PirTcpServer,
    save_serving_state,
)
from chalametpir_tpu.params import SEED_BYTE_LEN

from ..models.server import Server


def load_serving_state(prefix: str, device="cuda") -> tuple[Server, bytes, bytes, bytes]:
    """Inverse of save_serving_state, onto `device`: (server, seed, hint,
    filter_params). Reads the archives of either package."""
    server = Server.load(prefix + ".state", device)
    with np.load(prefix + ".setup") as a:
        return server, a["seed"].tobytes(), a["hint"].tobytes(), a["fparams"].tobytes()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--arity", type=int, default=3, choices=(3, 4))
    ap.add_argument("--random-db", type=int, default=0, metavar="N",
                    help="serve a random N-entry database instead of the demo")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the planes live and the respond runs (cpu: the plain versions)")
    ap.add_argument("--prg-mode", default="stream", choices=("stream", "ctr"),
                    help="A derivation; clients must match (stream = reference interop)")
    ap.add_argument("--save-state", metavar="PREFIX",
                    help="after setup, persist serving state to PREFIX.{state,setup}")
    ap.add_argument("--load-state", metavar="PREFIX",
                    help="skip setup and resume serving from a --save-state archive")
    args = ap.parse_args(argv)

    if args.load_state and (args.random_db or args.save_state):
        ap.error("--load-state resumes an archived server; it cannot be combined with "
                 "--random-db or --save-state (and it ignores --arity and --prg-mode, "
                 "which are baked into the archive)")
    if args.load_state:
        server, seed, hint, filter_params = load_serving_state(args.load_state, args.device)
        print(f"Resumed from {args.load_state}.state, hint {len(hint)} B", file=sys.stderr)
    else:
        if args.random_db:
            from chalametpir_tpu.utils import generate_random_kv_database

            db = generate_random_kv_database(args.random_db)
        else:
            db = DEMO_DB
        seed = os.urandom(SEED_BYTE_LEN)
        server, hint, filter_params = Server.setup(
            seed, db, arity=args.arity, prg_mode=args.prg_mode, device=args.device
        )
        print(f"Setup done: {len(db)} entries, hint {len(hint)} B", file=sys.stderr)
        if args.save_state:
            save_serving_state(args.save_state, server, seed, hint, filter_params)
            print(f"State saved to {args.save_state}.{{state,setup}}", file=sys.stderr)
    asyncio.run(PirTcpServer(server, seed, hint, filter_params).serve(args.host, args.port))


if __name__ == "__main__":
    main()
