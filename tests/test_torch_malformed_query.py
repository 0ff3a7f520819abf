"""What the servers of both packages do with malformed queries: eight probe
inputs, each through `Server.respond` and `Server.respond_batch` of the JAX
package's device and numpy servers and of every kind of serving state the
port has (packed planes, digit planes, a sharded mesh, the numpy oracle).
Each probe must raise the same exception type in every server, or return
the same bytes.

The JAX reference is imported inside the fixture, so the `cuda` tier
(`make check-cuda`) also collects this file on a GPU host without jax."""

import functools

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import Server
from chalametpir_tpu_torch.net.server import DEMO_DB
from chalametpir_tpu_torch.parallel import make_mesh

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

SEED = bytes(range(32))


def _row(m: int) -> np.ndarray:
    return np.random.default_rng(2).integers(0, 1 << 32, size=(1, m), dtype=np.uint32)


# probe name -> the input, built from the DB's m
PROBES = {
    "ten_bytes": lambda m: b"\x01" * 10,
    "empty_bytes": lambda m: b"",
    "one_d_array": lambda m: _row(m)[0],
    "wrong_width": lambda m: np.zeros((1, m + 1), np.uint32),
    "float64": lambda m: _row(m).astype(np.float64) / 3,
    "negative_int64": lambda m: -_row(m).astype(np.int64),
    "list_of_u32_max": lambda m: [[2**32 - 1] * m],
    "transposed_view": lambda m: np.ascontiguousarray(_row(m).T).T,
}


@functools.lru_cache(maxsize=None)
def _servers():
    """(the JAX package's servers, the port's), each set up on the same DB,
    seed and rng: the same D, so a well-formed query gets the same answer
    from every one."""
    import chalametpir_tpu

    def rng():
        return np.random.default_rng(1)

    jax_servers = {
        "jax": chalametpir_tpu.Server.setup(SEED, DEMO_DB, rng=rng())[0],
        "jax_numpy": chalametpir_tpu.Server.setup(SEED, DEMO_DB, backend="numpy", rng=rng())[0],
    }
    port_servers = {
        "packed": Server.setup(SEED, DEMO_DB, rng=rng(), device="cpu")[0],
        "digit2": Server.setup(SEED, DEMO_DB, layout="digit2", rng=rng(), device="cpu")[0],
        "sharded": Server.setup(SEED, DEMO_DB, rng=rng(), mesh=make_mesh(["cpu"] * 2, data=2, model=1))[0],
        "numpy": Server.setup(SEED, DEMO_DB, backend="numpy", rng=rng())[0],
    }
    return jax_servers, port_servers


def _outcome(call, probe):
    """("ok", the answer's bytes) or (the exception's class name, None):
    the two packages raise classes of the same names from their own
    modules."""
    try:
        answer = call(probe)
    except Exception as exc:  # noqa: BLE001 - the type is what is compared
        return type(exc).__name__, None
    return "ok", answer if isinstance(answer, bytes) else np.ascontiguousarray(answer, np.uint32).tobytes()


@pytest.mark.parametrize("probe", list(PROBES))
def test_malformed_queries_meet_what_the_jax_server_does(probe):
    jax_servers, port_servers = _servers()
    m = jax_servers["jax"].num_query_cols
    assert all(server.num_query_cols == m for server in port_servers.values())
    for method in ("respond", "respond_batch"):
        want = {_outcome(getattr(server, method), PROBES[probe](m)) for server in jax_servers.values()}
        assert len(want) == 1, (method, want)
        for kind, server in port_servers.items():
            assert _outcome(getattr(server, method), PROBES[probe](m)) in want, (method, kind)
