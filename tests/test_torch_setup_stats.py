"""`setup_stats` of the port's setups against the JAX package's: for each
setup path the port's key set is a superset of the JAX package's for the
same call, and every value has the JAX value's type (a number, a dict of
numbers, an int or None). The values are measurements and are not
compared."""

import numbers

import numpy as np
import pytest
import torch

import chalametpir_tpu_torch.models.client as port_client_module
from chalametpir_tpu_torch import Client, Server
from chalametpir_tpu_torch.parallel import make_mesh
from chalametpir_tpu_torch.utils import generate_random_kv_database

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

CPU_KEYS = {"wall", "main", "runtime", "external"}


def _db():
    g = np.random.default_rng(0x57A7)
    return generate_random_kv_database(300, rng=g, value_byte_len=(1, 64)), g.bytes(32)


def _kind(value):
    """The type class a setup_stats value is held to."""
    if isinstance(value, dict):
        return {k: _kind(v) for k, v in value.items()}
    if value is None or isinstance(value, (bool, str)):
        return type(value)
    if isinstance(value, numbers.Integral):
        return "int"
    if isinstance(value, numbers.Real):
        return "number"
    raise AssertionError(f"a setup_stats value of type {type(value)}")


def _same_kind(got, want) -> bool:
    """got fits want: an int fits a number; a dict fits a dict whose keys it
    holds, each value fitting; None and an int stand for one another where
    the JAX value is a count that may be missing (worker_minflt)."""
    if isinstance(want, dict):
        return isinstance(got, dict) and all(k in got and _same_kind(got[k], w) for k, w in want.items())
    if want == "number":
        return got in ("number", "int")
    if want in ("int", type(None)):
        return got in ("int", type(None))
    return got == want


def _assert_superset(port_stats: dict, jax_stats: dict):
    assert set(jax_stats) <= set(port_stats), set(jax_stats) - set(port_stats)
    assert _same_kind(_kind(port_stats), _kind(jax_stats)), (port_stats, jax_stats)


def _cpu_dict(stats, helper):
    cpu = stats["cpu_s"]
    assert set(cpu) == CPU_KEYS | {helper} and all(isinstance(v, float) and v >= 0 for v in cpu.values())


@pytest.mark.parametrize("path", ["ctr", "stream", "stream_block_rows", "sharded_ctr", "sharded_stream", "digit2", "numpy"])
def test_server_setup_stats_cover_the_jax_keys(path):
    import jax

    import chalametpir_tpu
    from chalametpir_tpu.parallel import make_mesh as jax_make_mesh

    db, seed = _db()
    port_kw, jax_kw = dict(device="cpu"), dict(backend="jax")
    mode = "ctr" if path.endswith("ctr") else "stream"
    if path.startswith("sharded"):
        if len(jax.devices()) < 2:
            pytest.skip("needs the virtual devices of tests/conftest.py")
        port_kw = dict(mesh=make_mesh(["cpu"] * 2, data=1, model=2))
        jax_kw["mesh"] = jax_make_mesh(jax.devices()[:2], data=1, model=2)
    elif path == "digit2":
        port_kw["layout"] = jax_kw["layout"] = "digit2"
    elif path == "numpy":
        port_kw["backend"] = jax_kw["backend"] = "numpy"
    elif path == "stream_block_rows":
        port_kw["hint_block_rows"] = jax_kw["hint_block_rows"] = 64
    jax_server, _, _ = chalametpir_tpu.Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(5), **jax_kw)
    server, _, _ = Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(5), **port_kw)
    _assert_superset(server.setup_stats, jax_server.setup_stats)
    stats = server.setup_stats
    if path == "numpy":
        assert stats == jax_server.setup_stats == {}
        return
    # what the bench path reads of a device setup, whatever the JAX path fills
    assert {"upload_bytes", "upload_s", "cpu_s", "phases_s", "wall_s"} <= set(stats)
    assert isinstance(stats["upload_bytes"], int) and stats["upload_bytes"] > 0
    assert isinstance(stats["upload_s"], float)
    if path == "ctr":
        assert jax_server.setup_stats  # the JAX pipelined ctr path fills its own
        _cpu_dict(stats, "worker")
        assert stats["worker_minflt"] is None or isinstance(stats["worker_minflt"], int)
    else:
        _cpu_dict(stats, "producer")
        if mode == "stream":
            assert stats["a_upload_bytes"] == 4 * 1774 * server.num_query_cols
    if path == "digit2":
        assert stats["hint_block_rows"] == 1774  # one block at this m


@pytest.mark.parametrize("path", ["ctr_resident", "ctr_streaming", "stream"])
def test_client_setup_stats_cover_the_jax_keys(path, monkeypatch):
    import chalametpir_tpu
    import chalametpir_tpu.models.client as jax_client_module

    db, seed = _db()
    mode = "stream" if path == "stream" else "ctr"
    _, hint, fparams = Server.setup(seed, db, prg_mode=mode, rng=np.random.default_rng(5), device="cpu")
    if path == "ctr_streaming":
        monkeypatch.setattr(jax_client_module, "RESIDENT_PLANES_MAX_BYTES", 0)
        monkeypatch.setattr(port_client_module, "RESIDENT_PLANES_MAX_BYTES", 0)
    jax_client = chalametpir_tpu.Client.setup(seed, hint, fparams, prg_mode=mode, device=True)
    client = Client.setup(seed, hint, fparams, prg_mode=mode, device="cpu")
    _assert_superset(client.setup_stats, jax_client.setup_stats)
    stats = client.setup_stats
    assert {"wall_s", "cpu_s", "sys_s", "minflt"} <= set(jax_client.setup_stats)
    assert isinstance(stats["minflt"], int) and isinstance(stats["sys_s"], float)
    assert stats["engine"] == ("streaming" if path == "ctr_streaming" else "resident")
    if path == "stream":
        assert {"xof_s", "alloc_s", "a_expand_s"} <= set(jax_client.setup_stats)
        assert {"xof_s", "alloc_s", "a_expand_s", "xof_cpu_s"} <= set(stats)
        assert all(isinstance(stats[k], float) and stats[k] >= 0 for k in ("xof_s", "alloc_s"))
    else:
        assert "xof_s" not in stats and "alloc_s" not in stats


def test_the_kind_check_tells_types_apart():
    """The comparison above is not vacuous: a missing key, a number where a
    dict belongs, a string where a number belongs and a missing dict entry
    all fail it."""
    want = {"upload_s": 0.5, "cpu_s": {"wall": 1.0, "main": 0.5}, "worker_minflt": None, "upload_bytes": 3}
    _assert_superset({**want, "more": 1, "worker_minflt": 7, "upload_s": 1}, want)
    for bad in ({k: v for k, v in want.items() if k != "upload_s"}, {**want, "cpu_s": 1.0},
                {**want, "upload_s": "fast"}, {**want, "cpu_s": {"wall": 1.0}}, {**want, "upload_bytes": 0.5}):
        with pytest.raises(AssertionError):
            _assert_superset(bad, want)
