"""Multi-process serving over torch.distributed.

Counterpart of chalametpir_tpu/parallel/multihost.py. The in-process mesh
(`parallel.sharding`) shards the encoded DB over the devices one process
drives. Here every process runs the same program: `initialize` joins the
process group, the mesh spans its ranks (rank r holds shard s of data row
d, (d, s) = divmod(r, model), on its own device), and the sums of the
hint and respond partials become all_reduce collectives.

Deployment modes:

* **torchrun** — every worker calls `initialize()` with no arguments (the
  launcher's MASTER_ADDR, RANK and WORLD_SIZE are read from the
  environment), then builds `mesh = make_multihost_mesh()` and runs
  `Server.setup(..., mesh=mesh)` with identical inputs on every worker.
* **explicit** — N processes with the coordinator's host:port and their
  ids passed in (`multihost_demo --launch N`; what the tests drive).

The group's backend is gloo, which reduces host tensors (a partial on a
card is staged through the host), unless NCCL is built in and there is a
card for every process: NCCL refuses two ranks on one device.

Determinism contract: every process must call `Server.setup` with
byte-identical inputs (db, seed, arity, rng state), since the encode and
filter retry loop must take the same path everywhere. Query bytes
originate on one process; `broadcast_query` ships them to the others
before the collective respond.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..core import matrix_io
from ..device import resolve_device
from .sharding import Mesh, make_mesh, mesh_shape  # noqa: F401  (make_mesh re-exported, as in the JAX package)


def _process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the process group. Under torchrun call with no arguments (the
    environment names the coordinator, the rank and the world size); else
    pass the coordinator's host:port, the number of processes and this
    process's id. Idempotent per process."""
    if dist.is_initialized():
        return
    if coordinator_address is None and not (num_processes is None and process_id is None):
        # dropping these would fall through to the environment, which on a
        # machine without a launcher means a surprise failure or a
        # single-process group
        raise ValueError(
            "process_id/num_processes require coordinator_address (under "
            "torchrun pass no arguments at all; the environment covers all three)"
        )
    world = num_processes if coordinator_address is not None else int(os.environ.get("WORLD_SIZE", 1))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if dist.is_nccl_available() and cards > 1 and cards >= world else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % cards)


def make_multihost_mesh(model: int | None = None, data: int = 1, device="cuda") -> Mesh:
    """(data, model) mesh over the ranks of the process group, this rank's
    shard on `device` ("cuda": card rank mod the visible cards, so two
    ranks may share one card). The default shards the DB's fingerprint
    dimension over every rank (data=1): respond sums cross processes."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    data, model = mesh_shape(dist.get_world_size(), data, model)
    return Mesh(data, model, group=dist.group.WORLD, device=device)


def _collective_device() -> torch.device:
    """Where a collective's tensors lie: the host for gloo, this rank's
    card for NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def warmup_collectives(timeout_s: float = 240.0) -> None:
    """Align every process at a barrier with a caller-chosen deadline, then
    run a one-element all_reduce, so that the first real collective (the
    hint sum inside setup, reached after each process has encoded the DB on
    its own) meets connections that are already formed. No-op with one
    process or no process group."""
    if _process_count() == 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier()
    ones = torch.ones(1, dtype=torch.int32, device=_collective_device())
    dist.all_reduce(ones)
    if int(ones) != dist.get_world_size():
        raise RuntimeError(f"warmup all_reduce gave {int(ones)} over {dist.get_world_size()} processes")


def _payload_shape(n: int) -> int:
    """Collective payload size for an n-byte query: the next power of two
    (floor 4 KB). Every process derives this from the broadcast header
    alone, so the payload collective's shape agrees everywhere."""
    size = 4096
    while size < n:
        size <<= 1
    return size


_SHUTDOWN_N = -2


def broadcast_query(query_bytes: bytes | None, max_len: int = 1 << 26) -> bytes | None:
    """Ship rank 0's serialized query to every process (the client talks
    TCP to one process; the collective respond needs the bytes everywhere).
    The other processes pass None.

    Two-phase: a one-element int64 header carries the byte length (or a
    sentinel), then a payload of `_payload_shape(length)` bytes, so a
    single-row respond broadcasts kilobytes, not a max_batch-deep buffer.

    An oversized query raises ValueError on every process: the source
    broadcasts a length of -1 instead of raising before the collective,
    which would leave the peers blocked in their broadcast.

    Returns None when the source broadcast a shutdown sentinel (see
    broadcast_shutdown): receivers use this to leave their serving loops."""
    if _process_count() == 1:
        if query_bytes is not None and len(query_bytes) + 8 > max_len:
            raise ValueError("query exceeds broadcast buffer")
        return query_bytes
    device = _collective_device()
    header = torch.zeros(1, dtype=torch.int64)
    if query_bytes is not None:
        header[0] = -1 if len(query_bytes) + 8 > max_len else len(query_bytes)
    header = header.to(device)
    dist.broadcast(header, src=0)
    n = int(header)
    if n == _SHUTDOWN_N:
        return None
    if n < 0:
        raise ValueError("query exceeds broadcast buffer")
    payload = torch.zeros(_payload_shape(n), dtype=torch.uint8)
    if query_bytes is not None:
        payload.numpy()[:n] = np.frombuffer(query_bytes, np.uint8)
    payload = payload.to(device)
    dist.broadcast(payload, src=0)
    return payload[:n].cpu().numpy().tobytes()


def broadcast_shutdown(max_len: int = 1 << 26) -> None:
    """Leader-side: release every worker blocked in broadcast_query(None)
    (their serving loops return). Header-only: receivers see the sentinel
    and never enter the payload collective."""
    del max_len  # kept for call-site compatibility; shutdown is header-only
    if _process_count() == 1:
        return
    dist.broadcast(torch.full((1,), _SHUTDOWN_N, dtype=torch.int64, device=_collective_device()), src=0)


# -- the serving loop ---------------------------------------------------------
#
# Multi-process online serving: the TCP surface lives on the leader (rank
# 0); every respond batch is a collective, so the worker processes must run
# the same respond_batch with the same queries. The leader's batch
# dispatcher broadcasts each stacked query batch (the wire format, rows =
# batch size) before running it; workers sit in worker_respond_loop doing
# broadcast -> respond until shutdown.

# The payload's shape derives from the broadcast header, so a batch-size
# mismatch cannot desynchronize the collectives; max_batch only caps the
# oversize check on the source. Keep leader and workers on this constant
# anyway so the cap they enforce agrees.
DEFAULT_SERVE_BATCH = 64


def _batch_max_len(server, max_batch: int) -> int:
    # length prefix + matrix header + max_batch rows of m u32 columns
    return 16 + 4 * max_batch * server.num_query_cols


def leader_respond_batch_fn(server, max_batch: int = DEFAULT_SERVE_BATCH):
    """Wrap server.respond_batch for the leader's BatchDispatcher: each
    batch is broadcast to the worker processes, then answered by the
    collective respond all processes now run together.

    Failure contract: if the leader's respond raises after its batch
    broadcast, the workers are already inside that batch's collective and
    the group is desynchronized: serving on would issue a mismatched
    collective (the next batch's header broadcast against the workers'
    stuck all_reduce) and wedge the transport with no error anywhere. The
    wrapper therefore poisons itself: every later call fails fast, so the
    serving group dies loudly and a supervisor restarts it together."""
    max_len = _batch_max_len(server, max_batch)
    state = {"poisoned": False}

    def respond_batch(rows: np.ndarray) -> np.ndarray:
        if state["poisoned"]:
            raise RuntimeError(
                "multi-host serving poisoned: a collective respond failed "
                "after its batch broadcast; the processes are "
                "desynchronized — restart the serving group"
            )
        broadcast_query(matrix_io.matrix_to_bytes(rows), max_len=max_len)
        try:
            return server.respond_batch(rows)
        except BaseException:
            state["poisoned"] = True
            raise

    return respond_batch


def worker_respond_loop(server, max_batch: int = DEFAULT_SERVE_BATCH) -> None:
    """Run on every non-leader process: take part in the leader's
    collective responds until it broadcasts shutdown.

    A worker that dies mid-loop leaves the leader blocked in its next
    broadcast until the process group's timeout: deploy workers under a
    supervisor that restarts the whole serving group together."""
    max_len = _batch_max_len(server, max_batch)
    while True:
        frame = broadcast_query(None, max_len=max_len)
        if frame is None:
            return
        try:
            server.respond_batch(matrix_io.matrix_from_bytes(frame))
        except BaseException as exc:
            # a worker-side respond failure desynchronizes the group (the
            # leader is inside this batch's collective): exit loudly so the
            # supervisor restarts the group
            print(
                f"worker_respond_loop: collective respond failed ({exc!r});"
                " the serving group is desynchronized — restart it together",
                file=sys.stderr, flush=True,
            )
            raise
