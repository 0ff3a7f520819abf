"""The port stands alone: it needs neither jax nor the JAX package. Full
CPU round trips through chalametpir_tpu_torch in ctr mode (the resident
and the streaming client engine) and in stream mode, server and client
save/load, a fetch through the port's TCP server and client, telemetry
with its profiler and trace lines, the public names and the client's
benchmarking hooks, the digit-layout respond and the scan diagnostic's
checks, a sharded server over an in-process mesh and the single-process
contracts of parallel/multihost, the digit2 layout and the numpy oracle
(ops/packed, ops/matmul_u32, ops/respond, the digit2 shard functions, the
setup diagnostics), run in a subprocess where importing jax
or chalametpir_tpu raises; the two-process demo and the quickstart under
the same block, and so is a run of bench_torch.py; and no source of the
port (parallel/ included), nor chip_smoke.py, bench_torch.py or
examples/quickstart_torch.py, imports either."""

import os
import signal
import subprocess
import sys

_BLOCK = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "chalametpir_tpu") or name.startswith(("jax.", "chalametpir_tpu.")):
            raise ImportError(f"{name} blocked for this test")
        return None

sys.meta_path.insert(0, _Block())
"""

_CODE = _BLOCK + r"""
import numpy as np
import torch
import chalametpir_tpu_torch
from chalametpir_tpu_torch import Client, Server, convert, kernels
from chalametpir_tpu_torch import Query, BinaryFuseFilter, SEED_BYTE_LEN, LWE_DIMENSION
from chalametpir_tpu_torch.diag import digit2_blocks, profile_setup, scan_qd
from chalametpir_tpu_torch.ops import client_device, digits, prg_torch, respond_digits, respond_packed
from chalametpir_tpu_torch.ops import matmul_u32, packed, respond
from chalametpir_tpu_torch.core import encode_db
from chalametpir_tpu_torch.native import engine as native_engine
from chalametpir_tpu_torch.parallel import shard_db_planes, sharded_hint_accumulate_fn, sharded_respond_fn
from chalametpir_tpu_torch.ops.client_device import StreamingQueryEngine
from chalametpir_tpu_torch.net import client as net_client, server as net_server
from chalametpir_tpu_torch.parallel import make_mesh, multihost, multihost_demo, sharding
from chalametpir_tpu_torch.utils import telemetry
import asyncio, contextlib, io, os, tempfile
import chalametpir_tpu_torch.models.client as port_client
from chalametpir_tpu_torch.errors import ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu_torch.utils import generate_random_kv_database

def query(client, key):
    while True:
        try:
            return client.query(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue

rng = np.random.default_rng(5)
db = generate_random_kv_database(300, rng=rng, value_byte_len=(1, 64))
seed = rng.bytes(32)
tmp = tempfile.mkdtemp()
telemetry.set_trace(True)
trace = io.StringIO()
with telemetry.profile_to(os.path.join(tmp, "trace")) as prof, contextlib.redirect_stderr(trace):
    stream_server, stream_hint, stream_fparams = Server.setup(seed, db, rng=rng, device="cpu")
telemetry.set_trace(False)
assert prof is not None and os.path.exists(os.path.join(tmp, "trace", "trace.json"))
assert "[trace] server_setup.encode_db:" in trace.getvalue()
stream_client = Client.setup(seed, stream_hint, stream_fparams, device="cpu")
server, hint, fparams = Server.setup(seed, db, prg_mode="ctr", rng=rng, device="cpu")
resident = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
port_client.RESIDENT_PLANES_MAX_BYTES = 0
streaming = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
assert isinstance(streaming._engine, StreamingQueryEngine)
for client, srv in ((resident, server), (streaming, server), (stream_client, stream_server)):
    for key in list(db)[:3]:
        assert client.process_response(key, srv.respond(query(client, key))) == db[key]
assert (SEED_BYTE_LEN, LWE_DIMENSION) == (32, 1774) and isinstance(stream_client._filter, BinaryFuseFilter)
key = list(db)[3]
pending = query(stream_client, key)
held = stream_client.discard_query(key)  # the benchmarking hooks
assert isinstance(held, Query) and stream_client.discard_query(key) is None
stream_client.insert_query(key, held)
stream_client.save(os.path.join(tmp, "client"))
stream_server.save(os.path.join(tmp, "server"))
loaded = Server.load(os.path.join(tmp, "server"), device="cpu")
assert Client.load(os.path.join(tmp, "client"), device="cpu").process_response(
    key, loaded.respond(pending)) == db[key]
queries = torch.from_numpy(rng.integers(0, 1 << 32, size=(3, server.num_query_cols),
                                        dtype=np.uint32).view(np.int32))
for layout in respond_digits.LAYOUTS:
    assert torch.equal(respond_digits.respond_batch_digits(queries, server.planes, layout),
                       respond_packed.respond_batch_packed(queries, server.planes))
tcp = net_server.PirTcpServer(stream_server, seed, stream_hint, stream_fparams)

async def fetch_over_tcp():
    srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
    async with srv:
        return await net_client.fetch("127.0.0.1", srv.sockets[0].getsockname()[1], list(db)[4:6],
                                      device="cpu")

assert asyncio.run(fetch_over_tcp()) == {key: db[key] for key in list(db)[4:6]}
mesh = make_mesh(["cpu"] * 4, data=2, model=2)
for mode, (plain, plain_hint) in (("ctr", (server, hint)), ("stream", (stream_server, stream_hint))):
    sharded, sharded_hint, _ = Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(9), mesh=mesh)
    again, again_hint, _ = Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(9), device="cpu")
    assert sharded_hint == again_hint and len(sharded_hint) == len(plain_hint)
    assert np.array_equal(sharded.respond_batch(queries.numpy().view(np.uint32)),
                          again.respond_batch(queries.numpy().view(np.uint32)))
fn = multihost.leader_respond_batch_fn(sharded)  # one process: the broadcast passes through
assert np.array_equal(fn(queries.numpy().view(np.uint32)), again.respond_batch(queries.numpy().view(np.uint32)))
multihost.warmup_collectives(timeout_s=1.0)
multihost.broadcast_shutdown()
assert telemetry.trace_enabled() is False
geo = scan_qd.Geometry(0, 9, 3000, 200)
gen = torch.Generator().manual_seed(1)
scan_qd.check(scan_qd.synthetic_planes(geo, "cpu", gen),
              torch.randint(-(1 << 31), 1 << 31, (8, geo.m), dtype=torch.int32, generator=gen))
# the digit2 layout, the numpy oracle and their library functions
oracle, oracle_hint, oracle_fparams = Server.setup(seed, db, backend="numpy", rng=np.random.default_rng(9))
digit2, digit2_hint, _ = Server.setup(seed, db, layout="digit2", hint_block_rows=100,
                                      rng=np.random.default_rng(9), device="cpu")
assert isinstance(oracle.planes, np.ndarray) and isinstance(digit2.planes, respond.DigitPlanes)
assert oracle_hint == digit2_hint == again_hint
q_np = queries.numpy().view(np.uint32)
assert np.array_equal(oracle.respond_batch(q_np), digit2.respond_batch(q_np))
assert np.array_equal(oracle.respond_batch(q_np), again.respond_batch(q_np))
digit2.save(os.path.join(tmp, "digit2"))
oracle.save(os.path.join(tmp, "oracle"))
assert Server.load(os.path.join(tmp, "digit2"), device="cpu").layout == "digit2"
assert Server.load(os.path.join(tmp, "oracle")).backend == "numpy"
assert np.array_equal(packed.unpack_db(packed.pack_db(oracle.planes, oracle.mat_elem_bit_len)), oracle.planes)
p0, p1 = digits.db_digit_planes_np(oracle.planes)
want = matmul_u32.matmul_u32_np(q_np, oracle.planes.astype(np.uint32))
assert np.array_equal(matmul_u32.matmul_u32_x_db(queries, torch.from_numpy(p0), torch.from_numpy(p1))
                      .numpy().view(np.uint32), want)
d0, d1 = shard_db_planes(mesh, p0, p1)
q_pad = torch.zeros((4, d0.m_pad), dtype=torch.int32)
q_pad[:3, : queries.shape[1]] = queries
assert np.array_equal(sharded_respond_fn(mesh)(q_pad, d0, d1)[:3].numpy().view(np.uint32), want)
step = sharded_hint_accumulate_fn(mesh)
assert torch.equal(step(torch.zeros((4, d0.num_cols), dtype=torch.int32), q_pad, d0, d1)[:3],
                   torch.from_numpy(want.view(np.int32)))
some_key = next(iter(db))
filt = BinaryFuseFilter.from_bytes(oracle_fparams)
assert encode_db.recover_value(oracle.planes.astype(np.uint32), some_key, filt) == db[some_key]
assert len(native_engine.turboshake128(b"abc", 40)) == 40
with contextlib.redirect_stderr(io.StringIO()) as profile_out:
    assert profile_setup.main(["8", "3", "--device", "cpu", "--prg-mode", "stream"]) == 0
assert "setup_stats.cpu_s" in profile_out.getvalue() and callable(digit2_blocks.main)
import shutil
shutil.rmtree(tmp)
assert not any(m in ("jax", "chalametpir_tpu") or m.startswith(("jax.", "chalametpir_tpu."))
               for m in sys.modules)
print("NO_JAX_OK")
"""


def test_port_round_trip_without_jax():
    # one intra-op thread: the tensors are small and the suite runs in
    # parallel workers
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CODE], capture_output=True, text=True, timeout=300, env=env
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stdout


def _run_blocked(code: str, argv: list[str], timeout: int) -> subprocess.CompletedProcess:
    """`code` under the import block, in a process group of its own that is
    killed whole on expiry (the demo starts processes of its own)."""
    proc = subprocess.Popen([sys.executable, "-c", _BLOCK + code, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"timed out:\n{(out + err)[-2000:]}")
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def test_quickstart_runs_on_the_cpu_without_jax():
    """examples/quickstart_torch.py --device cpu, the port's round trip as a
    script, where importing jax or chalametpir_tpu raises."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "quickstart_torch.py")
    code = "import runpy; sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')"
    for mode in ("ctr", "stream"):
        proc = _run_blocked(code, [path, "--device", "cpu", "--entries", "300", "--prg-mode", mode], 120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "quickstart OK" in proc.stdout and proc.stdout.count("value OK") == 3


def test_bench_runs_on_the_cpu_without_jax():
    """bench_torch.py --device cpu --log-n 10, the ctr cell, where importing
    jax or chalametpir_tpu raises: every phase and check to a correct end."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_torch.py")
    code = "import runpy; sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')"
    proc = _run_blocked(code, [path, "--cell", "ctr-2p20-a3", "--seed", "2", "--device", "cpu", "--log-n", "10"], 300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"phase":"done","correct":true' in proc.stdout.splitlines()[-1]


def test_multihost_demo_worker_without_jax():
    """One rank of the demo as a process group of its own (one process, a
    1 x 1 mesh) under the import block: initialize, warmup, the sharded
    setup, the broadcast and the respond import nothing of jax."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("from chalametpir_tpu_torch.parallel import multihost_demo; multihost_demo.main(sys.argv[1:]); "
            "assert not any(m.split('.')[0] in ('jax', 'chalametpir_tpu') for m in sys.modules)")
    proc = _run_blocked(code, ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0",
                               "--device", "cpu", "--entries", "200"], 120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "MULTIHOST OK" in proc.stdout


def test_port_sources_do_not_import_jax():
    """No line of the port's sources (parallel/ among them), nor of
    chip_smoke.py, bench_torch.py or the port's quickstart, imports jax or chalametpir_tpu
    (`import x`, `import x.y`, `from x import`, `from x.y import`), at any
    indentation."""
    import pathlib

    import chalametpir_tpu_torch

    root = pathlib.Path(chalametpir_tpu_torch.__file__).parent
    paths = [*root.rglob("*.py"), root.parent / "chip_smoke.py", root.parent / "bench_torch.py",
             root.parent / "examples" / "quickstart_torch.py"]
    assert {"sharding.py", "multihost.py", "multihost_demo.py"} <= {p.name for p in paths if p.parent.name == "parallel"}
    assert {"packed.py", "matmul_u32.py", "respond.py", "digits.py"} <= {p.name for p in paths if p.parent.name == "ops"}
    assert {"profile_setup.py", "digit2_blocks.py"} <= {p.name for p in paths if p.parent.name == "diag"}
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] not in (["import"], ["from"]) or len(words) < 2:
                continue
            for name in words[1].rstrip(",").split(","):
                top = name.split(".")[0]
                assert top not in ("jax", "chalametpir_tpu"), f"{path}: {line}"
