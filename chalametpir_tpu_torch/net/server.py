"""TCP PIR server on the port (reference: chalametpir_server/examples/server.rs).

Run: python -m chalametpir_tpu_torch.net.server [--host 127.0.0.1] [--port 8080]
     [--device cuda] [--prg-mode stream] [--mesh DATAxMODEL]

Serves the demo fruit database unless --random-db N is given. The
transport is the port's own copy of the JAX package's
(chalametpir_tpu/net/server.py): `PirTcpServer` sends each connection the
setup artifacts and answers its length-framed queries through one
`BatchDispatcher`, which stacks whatever queries are queued, from every
connection, into one respond_batch call, run in a worker thread.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

import numpy as np

from ..core import matrix_io
from ..errors import ChalametPIRError, IncompatibleDimensionForRowVectorTransposedMatrixMultiplication
from ..models.server import Server
from ..params import SEED_BYTE_LEN
from .framing import read_frame, write_frame


class BatchDispatcher:
    """Micro-batching bridge from asyncio connections to the device.

    Submitted queries wait in a queue; a single worker drains up to
    `max_batch` of them (everything already queued, no artificial delay)
    and answers them with one respond_batch call off-thread: one respond
    kernel launch for every query queued, from every connection. Batches
    are not padded unless `pad_batches` asks for it: the kernel compiles
    nothing per shape, and a padded batch would make a lone query pay for
    a 64-query respond."""

    def __init__(self, server: Server, max_batch: int = 64,
                 respond_batch_fn=None, pad_batches: bool | None = None):
        self._server = server
        self._max_batch = max_batch
        # pluggable batch hook: multi-process serving wraps respond_batch to
        # broadcast the stacked queries to the worker processes first
        # (parallel.multihost.leader_respond_batch_fn)
        self._respond_batch = respond_batch_fn or server.respond_batch
        # zero rows up to max_batch; their responses are zero and are never
        # read. None chooses, as in the JAX package, which pads for its jax
        # backend, whose respond compiles per batch shape: here no backend
        # compiles per shape, so None is off
        self._pad_batches = bool(pad_batches)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._busy = False  # a batch is currently being answered
        self._closed = False
        self.batches = 0  # served batch count (observability/tests)
        self.served = 0  # served query count

    async def submit(self, query_bytes: bytes) -> bytes:
        if self._closed:
            raise ConnectionError("batch dispatcher closed")
        # restart the worker if it died (cancellation, loop teardown, bug)
        # — otherwise every future submit would await a never-set future
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._worker())
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # parse/validate on the submitting task so framing errors surface
        # on the right connection
        q = matrix_io.matrix_from_bytes(query_bytes)
        if q.shape[0] != 1 or q.shape[1] != self._server.num_query_cols:
            raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
        await self._queue.put((q[0], fut))
        return await fut

    async def _worker(self):
        batch = []
        try:
            while True:
                batch = [await self._queue.get()]
                while len(batch) < self._max_batch and not self._queue.empty():
                    batch.append(self._queue.get_nowait())
                self._busy = True
                try:
                    rows = np.stack([q for q, _ in batch])
                    if self._pad_batches and rows.shape[0] < self._max_batch:
                        rows = np.pad(rows, ((0, self._max_batch - rows.shape[0]), (0, 0)))
                    out = await asyncio.to_thread(self._respond_batch, rows)
                except Exception as exc:  # propagate to every waiter
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(exc)
                    batch = []
                    self._busy = False
                    continue
                self.batches += 1
                self.served += len(batch)
                for i, (_, fut) in enumerate(batch):
                    if not fut.done():
                        fut.set_result(matrix_io.matrix_to_bytes(out[i][None, :]))
                batch = []
                self._busy = False
        finally:
            # worker is exiting (cancelled / loop teardown): fail the batch
            # in hand and everything still queued so no submitter hangs
            self._busy = False
            pending = [f for _, f in batch]
            while not self._queue.empty():
                try:
                    pending.append(self._queue.get_nowait()[1])
                except asyncio.QueueEmpty:
                    break
            for fut in pending:
                if not fut.done():
                    fut.set_exception(ConnectionError("batch dispatcher stopped"))

    async def aclose(self) -> None:
        """Quiesce the dispatcher: stop accepting submissions, let the
        queue drain and the in-flight batch finish, then stop the worker.
        After aclose() returns, no respond_batch call is running or
        will ever run."""
        self._closed = True
        while not self._queue.empty() or self._busy:
            await asyncio.sleep(0.01)
        if self._task is not None and not self._task.done():
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        # a submit that raced past the closed check may have enqueued after
        # the worker's own drain: fail it rather than leaving it hanging
        while not self._queue.empty():
            try:
                fut = self._queue.get_nowait()[1]
            except asyncio.QueueEmpty:
                break
            if not fut.done():
                fut.set_exception(ConnectionError("batch dispatcher closed"))

DEMO_DB = {
    b"apple": b"red", b"banana": b"yellow", b"grape": b"purple",
    b"orange": b"orange", b"lemon": b"yellow", b"blueberry": b"blue",
    b"kiwi": b"brown", b"watermelon": b"green", b"strawberry": b"red",
    b"peach": b"pink", b"pineapple": b"yellow", b"cherry": b"red",
    b"avocado": b"green", b"plum": b"purple", b"cantaloupe": b"orange",
}


class PirTcpServer:
    def __init__(self, server: Server, seed: bytes, hint: bytes,
                 filter_params: bytes, respond_batch_fn=None,
                 max_batch: int = 64):
        self._server = server
        self._seed = seed
        self._hint = hint
        self._filter_params = filter_params
        self._dispatcher = BatchDispatcher(
            server, max_batch=max_batch, respond_batch_fn=respond_batch_fn
        )
        # a valid query is exactly (1, m) u32 + the 8-byte header; cap the
        # frame reader there so a hostile 4-byte length prefix cannot make
        # this process buffer gigabytes
        self._max_query_frame = server.num_query_cols * 4 + 64
        self._active = 0  # connections currently inside handle()

    async def wait_idle(self, timeout: float = 10.0) -> bool:
        """Wait (bounded) until no connection handler is live — i.e.
        every response write has flushed and the peers disconnected.
        Orderly-shutdown helper: aclose() only quiesces the DISPATCHER;
        the responses it produced may still be sitting in handler tasks
        that asyncio.run teardown would cancel mid-write."""
        deadline = asyncio.get_running_loop().time() + timeout
        while self._active and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.02)
        return self._active == 0

    async def handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        print(f"New connection from PIR client @ {peer}", file=sys.stderr)
        self._active += 1
        try:
            writer.write(self._seed)
            write_frame(writer, self._hint)
            write_frame(writer, self._filter_params)
            await writer.drain()
            while True:
                try:
                    query = await read_frame(reader, self._max_query_frame)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                except ValueError as exc:  # oversized frame: drop the peer
                    print(f"Oversized frame from {peer}: {exc}", file=sys.stderr)
                    break
                try:
                    response = await self._dispatcher.submit(query)
                except ChalametPIRError as exc:
                    print(f"Bad query from {peer}: {exc}", file=sys.stderr)
                    break
                write_frame(writer, response)
                await writer.drain()
        except ConnectionError:
            # one handler for every normal departure: a peer aborting
            # mid-handshake or mid-response (reset/aborted/broken pipe),
            # AND the dispatcher's own ConnectionError when shutdown races
            # a late query — without this each escapes handle() as an
            # unhandled task exception
            pass
        finally:
            self._active -= 1
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def serve(self, host: str, port: int):
        srv = await asyncio.start_server(self.handle, host, port)
        print(f"PIR Server listening @ {host}:{port}", file=sys.stderr)
        async with srv:
            await srv.serve_forever()


def save_serving_state(prefix: str, server: Server, seed: bytes,
                       hint: bytes, filter_params: bytes) -> None:
    """Persist everything a restarted server process needs to resume
    serving without re-running setup: the device planes (Server.save)
    plus the per-connection setup blobs (seed/hint/filter params, which
    Server.save deliberately omits — they normally left at setup time)."""
    server.save(prefix + ".state")
    with open(prefix + ".setup", "wb") as f:
        np.savez(
            f,
            seed=np.frombuffer(seed, np.uint8),
            hint=np.frombuffer(hint, np.uint8),
            fparams=np.frombuffer(filter_params, np.uint8),
        )


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
    ap.add_argument("--backend", default="auto", choices=("auto", "torch", "numpy"),
                    help="torch (also auto): planes on --device; numpy: the host oracle, "
                         "D as uint16 and uint64 matmuls, --device is not read")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the planes live and the respond runs (cpu: the plain versions)")
    ap.add_argument("--prg-mode", default="stream", choices=("stream", "ctr"),
                    help="A derivation; clients must match (stream = reference interop)")
    ap.add_argument("--save-state", metavar="PREFIX",
                    help="after setup, persist serving state to PREFIX.{state,setup}")
    ap.add_argument("--load-state", metavar="PREFIX",
                    help="skip setup and resume serving from a --save-state archive")
    ap.add_argument("--mesh", metavar="DATAxMODEL",
                    help="serve the DB sharded over a device mesh, e.g. '1x4' (fingerprint rows "
                         "over 4 devices, the partial responses summed): with --device cuda the "
                         "visible CUDA devices, with --device cpu shards on the CPU")
    args = ap.parse_args(argv)

    if args.load_state and (args.random_db or args.save_state or args.mesh):
        ap.error("--load-state resumes an archived server; it cannot be combined with "
                 "--random-db, --save-state or --mesh (and it ignores --arity, --backend and "
                 "--prg-mode, which are baked into the archive)")
    if args.mesh and args.backend == "numpy":
        ap.error("--mesh requires the torch backend")
    if args.mesh and args.save_state:
        # Server.save on a sharded server gathers the planes, and the archive
        # would resume as an unsharded server, which one device may not hold
        ap.error("--save-state cannot archive a --mesh-sharded server; "
                 "re-run setup with --mesh on restart instead")
    if args.load_state:
        server, seed, hint, filter_params = load_serving_state(args.load_state, args.device)
        print(f"Resumed from {args.load_state}.state, hint {len(hint)} B", file=sys.stderr)
    else:
        if args.random_db:
            from ..utils import generate_random_kv_database

            db = generate_random_kv_database(args.random_db)
        else:
            db = DEMO_DB
        mesh = None
        if args.mesh:
            from ..parallel import make_mesh

            try:
                data, model = (int(x) for x in args.mesh.lower().split("x"))
            except ValueError:
                ap.error("--mesh expects DATAxMODEL, e.g. 1x4")
            mesh = make_mesh(["cpu"] * (data * model) if args.device == "cpu" else None,
                             data=data, model=model)
        seed = os.urandom(SEED_BYTE_LEN)
        server, hint, filter_params = Server.setup(
            seed, db, arity=args.arity, prg_mode=args.prg_mode, device=args.device, mesh=mesh,
            backend=args.backend,
        )
        print(f"Setup done: {len(db)} entries, hint {len(hint)} B", file=sys.stderr)
        if args.save_state:
            save_serving_state(args.save_state, server, seed, hint, filter_params)
            print(f"State saved to {args.save_state}.{{state,setup}}", file=sys.stderr)
    asyncio.run(PirTcpServer(server, seed, hint, filter_params).serve(args.host, args.port))


if __name__ == "__main__":
    main()
