"""The port never needs jax: full CPU round trips through
chalametpir_tpu_torch in ctr mode (the resident and the streaming client
engine) and in stream mode, server and client save/load, the TCP server
and client modules, telemetry with its profiler, the digit-layout
respond and the scan diagnostic's checks, run in a subprocess where
importing jax raises."""

import os
import subprocess
import sys

_CODE = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax blocked for this test")
        return None

sys.meta_path.insert(0, _Block())

import numpy as np
import torch
import chalametpir_tpu_torch
from chalametpir_tpu_torch import Client, Server, convert, kernels
from chalametpir_tpu_torch.diag import scan_qd
from chalametpir_tpu_torch.ops import client_device, digits, prg_torch, respond_digits, respond_packed
from chalametpir_tpu_torch.ops.client_device import StreamingQueryEngine
from chalametpir_tpu_torch.net import client as net_client, server as net_server
from chalametpir_tpu_torch.utils import telemetry
import os, tempfile
import chalametpir_tpu.models.client as host_client
from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu.utils import generate_random_kv_database

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
with telemetry.profile_to(os.path.join(tmp, "trace")) as prof:
    stream_server, stream_hint, stream_fparams = Server.setup(seed, db, rng=rng, device="cpu")
assert prof is not None and os.path.exists(os.path.join(tmp, "trace", "trace.json"))
stream_client = Client.setup(seed, stream_hint, stream_fparams, device="cpu")
server, hint, fparams = Server.setup(seed, db, prg_mode="ctr", rng=rng, device="cpu")
resident = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
host_client.RESIDENT_PLANES_MAX_BYTES = 0
streaming = Client.setup(seed, hint, fparams, prg_mode="ctr", device="cpu")
assert isinstance(streaming._engine, StreamingQueryEngine)
for client, srv in ((resident, server), (streaming, server), (stream_client, stream_server)):
    for key in list(db)[:3]:
        assert client.process_response(key, srv.respond(query(client, key))) == db[key]
key = list(db)[3]
pending = query(stream_client, key)
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
geo = scan_qd.Geometry(0, 9, 3000, 200)
gen = torch.Generator().manual_seed(1)
scan_qd.check(scan_qd.synthetic_planes(geo, "cpu", gen),
              torch.randint(-(1 << 31), 1 << 31, (8, geo.m), dtype=torch.int32, generator=gen))
import shutil
shutil.rmtree(tmp)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
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
    import pathlib

    import chalametpir_tpu_torch

    root = pathlib.Path(chalametpir_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert words[:2] not in (["import", "jax"], ["from", "jax"]), f"{path}: {line}"
            assert not (words[:1] == ["import"] and "jax." in line), f"{path}: {line}"
            assert not (words[:1] == ["from"] and len(words) > 1 and words[1].startswith("jax.")), f"{path}: {line}"
