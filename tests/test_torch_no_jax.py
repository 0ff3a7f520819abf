"""The port stands alone: it needs neither jax nor the JAX package. Full
CPU round trips through chalametpir_tpu_torch in ctr mode (the resident
and the streaming client engine) and in stream mode, server and client
save/load, a fetch through the port's TCP server and client, telemetry
with its profiler and trace lines, the public names and the client's
benchmarking hooks, the digit-layout respond and the scan diagnostic's
checks, run in a subprocess where importing jax or
chalametpir_tpu raises; and no source of the port, nor chip_smoke.py,
imports either."""

import os
import subprocess
import sys

_CODE = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "chalametpir_tpu") or name.startswith(("jax.", "chalametpir_tpu.")):
            raise ImportError(f"{name} blocked for this test")
        return None

sys.meta_path.insert(0, _Block())

import numpy as np
import torch
import chalametpir_tpu_torch
from chalametpir_tpu_torch import Client, Server, convert, kernels
from chalametpir_tpu_torch import Query, BinaryFuseFilter, SEED_BYTE_LEN, LWE_DIMENSION
from chalametpir_tpu_torch.diag import scan_qd
from chalametpir_tpu_torch.ops import client_device, digits, prg_torch, respond_digits, respond_packed
from chalametpir_tpu_torch.ops.client_device import StreamingQueryEngine
from chalametpir_tpu_torch.net import client as net_client, server as net_server
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
geo = scan_qd.Geometry(0, 9, 3000, 200)
gen = torch.Generator().manual_seed(1)
scan_qd.check(scan_qd.synthetic_planes(geo, "cpu", gen),
              torch.randint(-(1 << 31), 1 << 31, (8, geo.m), dtype=torch.int32, generator=gen))
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


def test_port_sources_do_not_import_jax():
    """No line of the port's sources, nor of chip_smoke.py, imports jax or
    chalametpir_tpu (`import x`, `import x.y`, `from x import`,
    `from x.y import`), at any indentation."""
    import pathlib

    import chalametpir_tpu_torch

    root = pathlib.Path(chalametpir_tpu_torch.__file__).parent
    paths = [*root.rglob("*.py"), root.parent / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] not in (["import"], ["from"]) or len(words) < 2:
                continue
            for name in words[1].rstrip(",").split(","):
                top = name.split(".")[0]
                assert top not in ("jax", "chalametpir_tpu"), f"{path}: {line}"
