"""The port's client engine (chalametpir_tpu_torch/ops/client_device.py)
against the JAX package's DeviceQueryEngine and the native host matvec
over the host-expanded ctr A. s . A is a u32 vector mod 2^32: the
tolerance is exact equality.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch.core import prg
from chalametpir_tpu_torch.native import engine as native
from chalametpir_tpu_torch.params import LWE_DIMENSION
from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _host_matvecs(a: np.ndarray, codes: np.ndarray) -> np.ndarray:
    return np.stack([native.ternary_matvec(c, a) for c in codes])


@pytest.mark.parametrize("q", [1, 3])
def test_matvec_batch_matches_jax_and_native(q, rng):
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine as JaxEngine

    m = 300
    seed = rng.bytes(32)
    codes = rng.integers(0, 3, size=(q, LWE_DIMENSION)).astype(np.int8)
    # a small generation step: the result cannot depend on it
    eng = DeviceQueryEngine.from_seed_ctr(seed, m, device="cpu", cols_per_step=128)
    got = eng.matvec_batch(codes)
    assert got.shape == (q, m) and got.dtype == np.uint32
    assert np.array_equal(got, JaxEngine.from_seed_ctr(seed, m).matvec_batch(codes))
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="ctr")
    assert np.array_equal(got, _host_matvecs(a, codes))
    assert np.array_equal(eng.matvec(codes[0]), got[0])


def test_async_result_follows_the_engine_contract(rng):
    """The base Client blocks, slices rows and np.asarray's the handle."""
    m = 200
    seed = rng.bytes(32)
    eng = DeviceQueryEngine.from_seed_ctr(seed, m, device="cpu", cols_per_step=64)
    codes = rng.integers(0, 3, size=(4, LWE_DIMENSION)).astype(np.int8)
    res = eng.matvec_batch_async(codes).block_until_ready()
    full = np.asarray(res)
    assert full.dtype == np.uint32 and full.shape[0] == 4 and full.shape[1] >= m
    assert np.array_equal(np.asarray(res[2:3])[0, :m], eng.matvec_batch(codes)[2])


def test_bad_codes_shape_raises(rng):
    from chalametpir_tpu_torch.errors import InvalidDimensionForVector

    eng = DeviceQueryEngine.from_seed_ctr(rng.bytes(32), 50, device="cpu", cols_per_step=64)
    with pytest.raises(InvalidDimensionForVector):
        eng.matvec_batch(np.zeros((2, LWE_DIMENSION - 1), np.int8))


@pytest.mark.cuda
def test_device_engine_on_cuda_matches_native(cuda):
    g = np.random.default_rng(11)
    m = 5000
    seed = g.bytes(32)
    codes = g.integers(0, 3, size=(3, LWE_DIMENSION)).astype(np.int8)
    eng = DeviceQueryEngine.from_seed_ctr(seed, m, device=cuda, cols_per_step=2048)
    assert eng.device.type == "cuda"
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="ctr")
    assert np.array_equal(eng.matvec_batch(codes), _host_matvecs(a, codes))
