"""Multi-process PIR demo: sharded setup + collective respond.

Counterpart of chalametpir_tpu/parallel/multihost_demo.py. Runs the full
protocol with the encoded DB sharded across the devices of several
processes: the hint and respond sums cross the process boundary as
torch.distributed collectives. Every process executes this same script;
the client lives on rank 0 and its query is broadcast before the
collective respond.

    python -m chalametpir_tpu_torch.parallel.multihost_demo --launch 2 [--device cpu]

spawns 2 worker processes, one shard each, on a (1, 2) mesh. `--device
cuda` (the default) puts rank r's shard on card r mod the visible cards,
so on a one-card machine both ranks share it and the sums go through gloo
on the host; `--device cpu` runs the plain versions. Under torchrun, omit
--launch, --coordinator, --num-processes and --process-id.

Online-serving mode (`--tcp-queries N [--port-file P]`): rank 0
additionally runs the TCP server; every respond batch is broadcast to the
workers and answered as one collective, so an unmodified `net.client`
retrieves values from the sharded DB.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", type=int, default=0, metavar="N",
                    help="launcher mode: spawn N worker processes and wait")
    # default None => the torchrun environment; the launcher always passes
    # all three explicitly to its workers
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=240,
                    help="launcher: seconds before the workers are killed")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where each rank keeps its shard (cpu: the plain versions)")
    ap.add_argument("--entries", type=int, default=300)
    ap.add_argument("--tcp-queries", type=int, default=0, metavar="N",
                    help="online-serving mode: rank 0 serves TCP until N queries are "
                         "answered (each respond batch is a collective across all processes)")
    ap.add_argument("--port-file", default=None,
                    help="tcp mode: write the bound port here for the caller")
    return ap.parse_args(argv)


def launch(args) -> int:
    """Spawn the workers and wait, with a deadline; the exit code is nonzero
    if any worker fails. A worker that wedges (one peer died before the
    collectives formed, the other blocks in gloo) is killed at the
    deadline instead of hanging the launcher's caller forever."""
    coordinator = args.coordinator or "127.0.0.1:29811"
    env = dict(os.environ)
    if coordinator.rsplit(":", 1)[0] in ("127.0.0.1", "localhost"):
        # all ranks on one host: gloo over the loopback interface,
        # whatever the host name resolves to
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for pid in range(args.launch):
        cmd = [
            sys.executable, "-m", "chalametpir_tpu_torch.parallel.multihost_demo",
            "--coordinator", coordinator,
            "--num-processes", str(args.launch),
            "--process-id", str(pid),
            "--device", args.device,
            "--entries", str(args.entries),
            # workers size their warmup barrier from --timeout
            "--timeout", str(args.timeout),
        ]
        if args.tcp_queries:
            cmd += ["--tcp-queries", str(args.tcp_queries)]
            if args.port_file and pid == 0:
                cmd += ["--port-file", args.port_file]
        procs.append(subprocess.Popen(cmd, env=env))
    deadline = time.monotonic() + args.timeout
    rc = 0
    try:
        for p in procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                rc |= p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                rc |= 124
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            if p.poll() is None:
                p.wait()
    return rc


def worker(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..errors import ArithmeticOverflowAddingQueryIndicator
    from ..models.client import Client
    from ..models.server import Server
    from ..utils import generate_random_kv_database
    from . import multihost

    if args.device == "cpu":
        # several ranks share one host's cores
        torch.set_num_threads(1)
    multihost.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    pid = dist.get_rank()
    print(f"[p{pid}] joined: rank {pid} of {dist.get_world_size()}, "
          f"backend {dist.get_backend()}", flush=True)
    # form the connections while the processes are aligned: the first real
    # collective (the hint sum inside setup) only happens after each
    # process has encoded the DB on its own
    multihost.warmup_collectives(timeout_s=args.timeout)
    print(f"[p{pid}] collectives warmed", flush=True)

    # identical inputs on every process (the determinism contract)
    rng = np.random.default_rng(0xD157)
    db = generate_random_kv_database(args.entries, rng=rng, value_byte_len=(1, 64))
    seed = bytes(range(32))
    mesh = multihost.make_multihost_mesh(model=dist.get_world_size(), device=args.device)
    server, hint, fparams = Server.setup(
        seed, db, arity=3, mesh=mesh, prg_mode="ctr",
        rng=np.random.default_rng(1),
    )
    print(f"[p{pid}] sharded setup done (m={server.num_query_cols}, shard on {mesh.device})", flush=True)

    if args.tcp_queries:
        _serve_tcp(args, pid, server, seed, hint, fparams)
        return

    key = sorted(db)[len(db) // 2]
    if pid == 0:
        client = Client.setup(seed, hint, fparams, prg_mode="ctr", device=args.device)
        while True:
            try:
                q_bytes = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                continue
    else:
        client, q_bytes = None, None

    # wire length is the same on every process: 8-byte header + m u32
    wire_len = 8 + 8 + 4 * server.num_query_cols
    q_bytes = multihost.broadcast_query(q_bytes, max_len=wire_len)
    resp = server.respond(q_bytes)  # collective: the sum crosses processes

    if pid == 0:
        value = client.process_response(key, resp)
        if value != db[key]:
            raise AssertionError("multihost retrieval mismatch")
        print("MULTIHOST OK", flush=True)
    print(f"[p{pid}] done", flush=True)


def _serve_tcp(args, pid, server, seed, hint, fparams) -> None:
    """Online-serving mode: the leader runs the TCP surface, each respond
    batch broadcast to the workers and answered as one collective; workers
    sit in the respond loop until the leader has served --tcp-queries
    queries and broadcasts shutdown."""
    from . import multihost

    if pid != 0:
        multihost.worker_respond_loop(server)
        print(f"[p{pid}] worker loop done", flush=True)
        return

    import asyncio

    from ..net.server import PirTcpServer

    tcp = PirTcpServer(
        server, seed, hint, fparams,
        respond_batch_fn=multihost.leader_respond_batch_fn(server),
        max_batch=multihost.DEFAULT_SERVE_BATCH,
    )

    async def serve():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, args.port_file)  # atomic: readers never see ""
        print(f"TCP_PORT={port}", flush=True)
        async with srv:
            while tcp._dispatcher.served < args.tcp_queries:
                await asyncio.sleep(0.05)
        # quiesce before the shutdown broadcast: aclose() guarantees no
        # batch broadcast is running or can start, so the shutdown
        # collective below comes strictly after every batch collective (a
        # late extra query gets a clean ConnectionError). Then wait for
        # the handler tasks to finish flushing the responses the
        # dispatcher produced
        await tcp._dispatcher.aclose()
        if not await tcp.wait_idle(timeout=10.0):
            print("warning: connections still active at shutdown", file=sys.stderr, flush=True)

    asyncio.run(serve())
    multihost.broadcast_shutdown(multihost._batch_max_len(server, multihost.DEFAULT_SERVE_BATCH))
    print("MULTIHOST TCP OK", flush=True)


def main(argv=None) -> None:
    args = _parse(argv)
    if args.launch:
        sys.exit(launch(args))
    worker(args)
    import torch.distributed as dist

    # leave in step, no rank tearing its connections down while a peer is
    # in a collective; the mesh and servers went with worker(), so nothing
    # holds the group and it is freed here, not at interpreter exit
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
