"""The port's multi-process serving (chalametpir_tpu_torch/parallel/
multihost.py, multihost_demo.py) after the seven tests of
tests/test_multihost.py: the single-process contracts through both
packages, then real process groups on the CPU (torch.distributed, gloo):
two processes through the demo, sharded round trip and TCP serving, and 2
and 4 ranks that check the int32 all_reduce wrap, the oversize sentinel,
the serving loop with its shutdown, and a sharded setup whose bytes equal
the single-process port's. Exact equality throughout.

Every multi-process test picks a free port, runs its children in a process
group of their own with a deadline, and kills that group on expiry."""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Server
from chalametpir_tpu_torch.net.server import DEMO_DB
from chalametpir_tpu_torch.parallel import multihost

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

DEADLINE_S = 120


def _both():
    from chalametpir_tpu.parallel import multihost as jax_multihost

    return multihost, jax_multihost


def test_broadcast_query_single_process_contract():
    """One process: bytes pass through unchanged and an oversized query
    raises the ValueError the sentinel raises on every peer."""
    payload = b"\x01\x02\x03" * 11
    for mh in _both():
        assert mh.broadcast_query(payload, max_len=64) == payload
        assert mh.broadcast_query(b"x" * 56, max_len=64) == b"x" * 56
        with pytest.raises(ValueError, match="query exceeds broadcast buffer"):
            mh.broadcast_query(b"x" * 57, max_len=64)
        assert mh.broadcast_query(None) is None
        mh.broadcast_shutdown()  # nobody to release


def test_payload_shape_equals_the_jax_function():
    port, ref = _both()
    assert port._payload_shape(0) == 4096
    assert port._payload_shape(4097) == 8192
    for n in [0, 1, 4095, 4096, 4097, 8192, 8193, 1 << 20, (1 << 20) + 1, (1 << 26) - 1, 1 << 26]:
        assert port._payload_shape(n) == ref._payload_shape(n)
    assert (port._SHUTDOWN_N, port.DEFAULT_SERVE_BATCH) == (ref._SHUTDOWN_N, ref.DEFAULT_SERVE_BATCH)


def test_leader_respond_poisons_after_broadcast_failure(rng):
    """A respond failing after its batch broadcast leaves the workers
    inside that batch's collective: the wrapper re-raises the error once,
    then fails fast on every later call, in both packages."""
    import chalametpir_tpu

    seed = rng.bytes(32)
    port_server, _, _ = Server.setup(seed, DEMO_DB, rng=np.random.default_rng(1), device="cpu")
    jax_server, _, _ = chalametpir_tpu.Server.setup(seed, DEMO_DB, backend="numpy", rng=np.random.default_rng(1))
    for mh, server in zip(_both(), (port_server, jax_server)):
        assert mh._batch_max_len(server, 4) == 16 + 4 * 4 * server.num_query_cols
        boom = {"on": True}
        orig = server.respond_batch

        def flaky(rows, boom=boom, orig=orig):
            if boom["on"]:
                raise RuntimeError("transient device failure")
            return orig(rows)

        rows = np.zeros((1, server.num_query_cols), np.uint32)
        healthy = mh.leader_respond_batch_fn(server, max_batch=4)
        assert np.array_equal(healthy(rows), orig(rows))
        server.respond_batch = flaky
        fn = mh.leader_respond_batch_fn(server, max_batch=4)
        with pytest.raises(RuntimeError, match="transient device failure"):
            fn(rows)
        boom["on"] = False  # even a now-healthy respond must not run again
        with pytest.raises(RuntimeError, match="poisoned"):
            fn(rows)


def test_warmup_collectives_single_process_noop():
    for mh in _both():
        mh.warmup_collectives(timeout_s=1.0)


def test_initialize_rejects_partial_cluster_spec():
    """process_id / num_processes without a coordinator raise in both
    packages instead of falling through to autodetection."""
    for mh in _both():
        with pytest.raises(ValueError):
            mh.initialize(process_id=0)
        with pytest.raises(ValueError):
            mh.initialize(num_processes=2)
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _communicate(proc, what: str, timeout: float = DEADLINE_S) -> str:
    """The process's output once it has ended; on expiry its whole process
    group is killed and the test fails."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{what} timed out:\n{(out + err)[-3000:]}")
    combined = out + err
    assert proc.returncode == 0, f"{what} failed:\n{combined[-3000:]}"
    return combined


def _demo(*args) -> subprocess.Popen:
    # own process group, killed whole: the workers inherit the captured
    # pipes, so killing only the launcher would leave communicate() blocked
    # on a wedged grandchild holding the write end open
    return subprocess.Popen(
        [sys.executable, "-m", "chalametpir_tpu_torch.parallel.multihost_demo",
         "--launch", "2", "--device", "cpu", "--coordinator", f"127.0.0.1:{_free_port()}",
         "--entries", "300", "--timeout", str(DEADLINE_S - 20), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )


def test_two_process_sharded_round_trip():
    combined = _communicate(_demo(), "multihost demo")
    assert "MULTIHOST OK" in combined, f"no MULTIHOST OK in:\n{combined[-3000:]}"
    assert combined.count("backend gloo") == 2


def test_two_process_tcp_serving_round_trip(tmp_path):
    """Online serving across processes: the leader's TCP surface answers an
    external client while every respond batch runs as a collective with
    the worker process, then releases the worker."""
    from chalametpir_tpu_torch.net.client import fetch
    from chalametpir_tpu_torch.utils import generate_random_kv_database

    port_file = str(tmp_path / "port")
    proc = _demo("--tcp-queries", "2", "--port-file", port_file)
    try:
        deadline = time.time() + DEADLINE_S - 30
        port = None
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(port_file):
                port = int(open(port_file).read())
                break
            time.sleep(0.1)
        assert port, "leader never published its TCP port"
        # the DB the demo builds (the determinism contract)
        db = generate_random_kv_database(300, rng=np.random.default_rng(0xD157), value_byte_len=(1, 64))
        keys = sorted(db)[:2]
        results = asyncio.run(fetch("127.0.0.1", port, keys, prg_mode="ctr", device="cpu"))
        assert results == {k: db[k] for k in keys}
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    combined = _communicate(proc, "multihost tcp demo", timeout=60)
    assert "MULTIHOST TCP OK" in combined and "worker loop done" in combined


# One rank of a scenario: argv = scenario, rank, world, coordinator port.
_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from chalametpir_tpu_torch import Server
from chalametpir_tpu_torch.parallel import multihost, sharding
from chalametpir_tpu_torch.utils import generate_random_kv_database

scenario, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
multihost.initialize(f"127.0.0.1:{port}", world, rank)
multihost.initialize(f"127.0.0.1:{port}", world, rank)  # idempotent
assert dist.get_backend() == "gloo" and dist.get_world_size() == world
multihost.warmup_collectives(timeout_s=90)
data = 2 if world == 4 else 1


def sharded_server(mesh, mode):
    rng = np.random.default_rng(11)
    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    kw = dict(arity=3, prg_mode=mode)
    server, hint, fparams = Server.setup(seed, db, mesh=mesh, rng=np.random.default_rng(3), **kw)
    one, one_hint, one_fparams = Server.setup(seed, db, device="cpu", rng=np.random.default_rng(3), **kw)
    assert (hint, fparams) == (one_hint, one_fparams), f"{mode}: sharded bytes differ from one process's"
    return server, one


def run(mesh):
    assert dict(mesh.shape) == {"data": data, "model": world // data}
    assert list(mesh.cells()) == [(*divmod(rank, world // data), torch.device("cpu"))]
    if scenario == "wrap":
        # gloo's int32 SUM wraps mod 2^32, through the port's own reduction
        vals = [0x7FFFFFFF, -0x80000000, 0x7FFFFFF0, 5]
        got = sharding._sum_partials(mesh, {torch.device("cpu"): torch.tensor(vals, dtype=torch.int32)})
        want = [((v * world + (1 << 31)) % (1 << 32)) - (1 << 31) for v in vals]
        assert got.tolist() == want, (got.tolist(), want)
        if world == 4:
            assert want == [-4, 0, -64, 20]
    elif scenario == "oversize":
        # the sentinel raises on every rank, and the group still works after it
        try:
            multihost.broadcast_query(b"x" * 57 if rank == 0 else None, max_len=64)
            raise SystemExit("no ValueError for an oversized query")
        except ValueError as exc:
            assert "query exceeds broadcast buffer" in str(exc)
        payload = bytes(range(256)) * 40  # 10,240 bytes: a 16 KB payload collective
        assert multihost.broadcast_query(payload if rank == 0 else None) == payload
        assert multihost.broadcast_query(b"" if rank == 0 else None) == b""
    elif scenario == "serve":
        # the leader's wrapped respond_batch against the workers' loop, then shutdown
        server, one = sharded_server(mesh, "stream")
        if rank == 0:
            fn = multihost.leader_respond_batch_fn(server)
            g = np.random.default_rng(5)
            for nq in (1, 3, 64):
                rows = g.integers(0, 1 << 32, size=(nq, server.num_query_cols), dtype=np.uint32)
                assert np.array_equal(fn(rows), one.respond_batch(rows))
            multihost.broadcast_shutdown()
        else:
            multihost.worker_respond_loop(server)
    elif scenario == "setup":
        # every rank holds its own shard alone and returns the full answer
        for mode in ("ctr", "stream"):
            server, one = sharded_server(mesh, mode)
            planes = server.planes
            (s0, lo, hi), = planes.runs.values()
            assert s0 == rank % mesh.shape["model"] and lo.shape[0] == planes.m_local == planes.m_pad // mesh.shape["model"]
            g = np.random.default_rng(6)
            for nq in (1, 4):
                rows = g.integers(0, 1 << 32, size=(nq, server.num_query_cols), dtype=np.uint32)
                assert np.array_equal(server.respond_batch(rows), one.respond_batch(rows))
            try:
                server.save("/dev/null")
                raise SystemExit("a rank saved a server of which it holds one shard")
            except ValueError:
                pass
    else:
        raise SystemExit(f"unknown scenario {scenario}")


run(multihost.make_multihost_mesh(model=world // data, data=data, device="cpu"))
# the mesh and every server over it went with run(): nothing holds the group
# past its destruction, so it is freed here and not at interpreter exit
dist.barrier()
dist.destroy_process_group()
print(f"RANK{rank} {scenario} OK", flush=True)
"""

# Starts the ranks, ends them all as soon as one fails.
_LAUNCH = r"""
import subprocess, sys, time
code, scenario, world, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
procs = [subprocess.Popen([sys.executable, "-c", code, scenario, str(r), str(world), port]) for r in range(world)]
while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
    time.sleep(0.05)
for p in procs:
    if p.poll() is None and any(q.poll() for q in procs):
        p.kill()
sys.exit(1 if any(p.wait() for p in procs) else 0)
"""


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("scenario", ["wrap", "oversize", "serve", "setup"])
def test_gloo_ranks(scenario, world):
    proc = subprocess.Popen(
        [sys.executable, "-c", _LAUNCH, _RANK, scenario, str(world), str(_free_port())],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo"),
    )
    combined = _communicate(proc, f"{world} ranks, {scenario}")
    for rank in range(world):
        assert f"RANK{rank} {scenario} OK" in combined, combined[-3000:]
