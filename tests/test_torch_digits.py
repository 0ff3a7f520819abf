"""The port's digit recode and its glue (chalametpir_tpu_torch/ops/digits.py)
against the JAX package: `recode_u32_np` / `recode_u32_jnp`
(chalametpir_tpu/ops/digits.py) and `_prepare_query_digits` / `_combine`
(chalametpir_tpu/ops/respond_pallas.py). Digits and u32 words are
integers: the tolerance is exact equality."""

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch.ops import digits

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

# words whose digit carries run through every position
EDGES = np.array([0, 1, 127, 128, 255, 256, 0x7F7F7F7F, 0x80808080, 0x7FFFFFFF,
                  0x80000000, 0xFFFFFF80, 0xFFFFFFFF], np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("shape", [(12,), (3, 257), (2, 5, 64)])
def test_recode_matches_numpy_and_jax(shape, rng):
    from chalametpir_tpu.ops.digits import recode_u32_jnp, recode_u32_np

    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    x.reshape(-1)[: min(x.size, EDGES.size)] = EDGES[: min(x.size, EDGES.size)]
    got = digits.recode_u32(_i32(x)).numpy()
    assert got.dtype == np.int8 and got.shape == (4,) + shape
    assert np.array_equal(got, recode_u32_np(x))
    assert np.array_equal(got, np.asarray(recode_u32_jnp(x)))


def test_recode_rejects_non_int32():
    with pytest.raises(ValueError):
        digits.recode_u32(torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("q,m,m_pad", [(1, 100, 128), (3, 257, 512), (8, 300, 300), (9, 64, 2048)])
def test_prepare_query_digits_matches_jax(q, m, m_pad, rng):
    from chalametpir_tpu.ops.respond_pallas import _prepare_query_digits

    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    qd, sums = digits.prepare_query_digits(_i32(queries), m_pad)
    want_qd, want_sums = _prepare_query_digits(queries, m_pad)
    assert qd.shape == (-(-4 * q // 32) * 32, m_pad) and qd.dtype == torch.int8
    assert np.array_equal(qd.numpy(), np.asarray(want_qd))
    assert np.array_equal(sums.numpy(), np.asarray(want_sums))


def test_prepare_query_digits_rejects_short_m_pad():
    with pytest.raises(ValueError):
        digits.prepare_query_digits(torch.zeros((1, 10), dtype=torch.int32), 8)


@pytest.mark.parametrize("with_hi", [False, True])
@pytest.mark.parametrize("q", [1, 5, 8])
def test_combine_matches_jax(q, with_hi, rng):
    """Raw int32 partials anywhere in their range, so every shift and the
    bias sums wrap."""
    from chalametpir_tpu.ops.respond_pallas import _combine

    rows, c_pad, c = -(-4 * q // 32) * 32, 256, 200
    out_lo = rng.integers(-(1 << 31), 1 << 31, size=(rows, c_pad), dtype=np.int32)
    out_hi = rng.integers(-(1 << 31), 1 << 31, size=(rows - rows // 4, c_pad), dtype=np.int32)
    sums = rng.integers(-(1 << 24), 1 << 24, size=(4, q), dtype=np.int32)
    hi = out_hi if with_hi else None
    got = digits.combine(torch.from_numpy(out_lo), torch.from_numpy(hi) if with_hi else None,
                         torch.from_numpy(sums).to(torch.int64), q, c)
    assert got.shape == (q, c) and got.dtype == torch.int32
    want = np.asarray(_combine(out_lo, hi, sums, q, c))
    assert np.array_equal(got.numpy().view(np.uint32), want)
