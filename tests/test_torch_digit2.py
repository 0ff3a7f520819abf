"""The digit2 layout of the port (chalametpir_tpu_torch/ops: digits,
packed, matmul_u32, respond) against the JAX package's modules of the same
names and against the uint64 numpy product. Digits, planes and u32 words
are integers: the tolerance is exact equality. The JAX functions run as
the JAX package's own tests run them on the CPU (plain jit, no Pallas:
the digit2 path has no kernel).

The JAX reference is imported inside the tests that use it, so the `cuda`
tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chalametpir_tpu_torch.errors import IncompatibleDimensionForMatrixMultiplication
from chalametpir_tpu_torch.ops import digits, matmul_u32, packed, respond, respond_packed

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

# words whose digit carries run through every position; 0x7F7F7F80 is four
# digits of -128
EDGES = np.array([0, 1, 127, 128, 255, 256, 0x7F7F7F7F, 0x7F7F7F80, 0x80808080, 0x7FFFFFFF,
                  0x80000000, 0xFFFFFF80, 0xFFFFFFFF], np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().numpy().view(np.uint32)


def _words(rng, shape) -> np.ndarray:
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    flat = x.reshape(-1)
    n = min(flat.size, EDGES.size)
    flat[:n] = EDGES[:n]
    return x


def _planes(d: np.ndarray):
    p0, p1 = digits.db_digit_planes_np(d)
    return torch.from_numpy(p0), torch.from_numpy(p1)


# -- ops/digits.py -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(13,), (3, 257), (2, 5, 64)])
def test_numpy_recode_is_the_jax_modules(shape, rng):
    from chalametpir_tpu.ops import digits as jax_digits

    x = _words(rng, shape)
    got = digits.recode_u32_np(x)
    assert got.dtype == np.int8 and got.tobytes() == jax_digits.recode_u32_np(x).tobytes()
    assert np.array_equal(digits.digits_to_u32_np(got), x)
    assert np.array_equal(digits.digits_to_u32_np(got), jax_digits.digits_to_u32_np(got))
    assert (digits.NUM_U32_DIGITS, digits.NUM_DB_DIGITS) == (jax_digits.NUM_U32_DIGITS, jax_digits.NUM_DB_DIGITS)


def test_device_recode_gives_the_jax_device_digits():
    """recode_u32 (torch) against recode_u32_jnp: four planes, carries
    included, 0xFFFFFFFF and the all -128 word among the cases."""
    from chalametpir_tpu.ops.digits import recode_u32_jnp

    got = digits.recode_u32(_i32(EDGES)).numpy()
    assert got.shape == (4, EDGES.size)
    assert np.array_equal(got, np.asarray(recode_u32_jnp(EDGES)))
    assert got[:, list(EDGES).index(0x7F7F7F80)].tolist() == [-128] * 4
    assert got[:, list(EDGES).index(0xFFFFFFFF)].tolist() == [-1, 0, 0, 0]


@pytest.mark.parametrize("b", [1, 8, 9, 13, 14])
def test_db_digit_planes_are_the_jax_modules(b, rng):
    from chalametpir_tpu.ops import digits as jax_digits

    d = rng.integers(0, 1 << b, size=(301, 77), dtype=np.uint32)
    d[0, :4] = [0, (1 << b) - 1, 127 % (1 << b), 128 % (1 << b)]
    for mat in (d, d.astype(np.uint16)):
        p0, p1 = digits.db_digit_planes_np(mat)
        q0, q1 = jax_digits.db_digit_planes_np(mat)
        assert (p0.tobytes(), p1.tobytes()) == (q0.tobytes(), q1.tobytes())
        assert p1.min() >= 0 and p1.max() <= 64
        assert np.array_equal(p0.astype(np.int64) + 256 * p1.astype(np.int64), d)


# -- ops/packed.py -------------------------------------------------------------


@pytest.mark.parametrize("b", range(1, 15))
def test_pack_db_is_the_jax_modules_and_round_trips(b, rng):
    from chalametpir_tpu.ops import packed as jax_packed

    mat = rng.integers(0, 1 << b, size=(67, 131), dtype=np.uint32)
    mat[0, :2] = [0, (1 << b) - 1]
    got, want = packed.pack_db(mat, b), jax_packed.pack_db(mat, b)
    assert got.lo_biased.tobytes() == want.lo_biased.tobytes()
    assert (got.hi_packed is None) == (want.hi_packed is None) == (b <= 8)
    if b > 8:
        assert got.hi_packed.shape == want.hi_packed.shape
        assert got.hi_packed.tobytes() == want.hi_packed.tobytes()
        assert np.array_equal(packed.unpack_hi(got.hi_packed, b, 131), jax_packed.unpack_hi(want.hi_packed, b, 131))
    assert (got.mat_elem_bit_len, got.num_rows, got.num_cols) == (b, 67, 131)
    assert got.bytes_per_element == want.bytes_per_element
    assert np.array_equal(packed.unpack_db(got), mat)
    assert (packed.hi_bits(b), packed.hi_pack_factor(b)) == (jax_packed.hi_bits(b), jax_packed.hi_pack_factor(b))
    # the old home of the two helpers still exports them
    assert respond_packed.hi_bits is packed.hi_bits and respond_packed.hi_pack_factor is packed.hi_pack_factor


# -- ops/matmul_u32.py, ops/respond.py -------------------------------------------


@settings(max_examples=25, deadline=None)
@given(r=st.integers(1, 40), k=st.integers(1, 700), c=st.integers(1, 45), b=st.integers(1, 14),
       seed=st.integers(0, 2**32 - 1))
def test_products_match_jax_and_the_u64_product(r, k, c, b, seed):
    """matmul_u32_x_db, digit_matmul_accumulate and respond_batch: rows 1-40,
    c and K mostly no multiple of 8, against the JAX functions and the
    uint64 numpy product."""
    from chalametpir_tpu.ops import matmul_u32 as jax_mm
    from chalametpir_tpu.ops import respond as jax_respond

    g = np.random.default_rng(seed)
    a = _words(g, (r, k))
    d = g.integers(0, 1 << b, size=(k, c), dtype=np.uint32)
    acc = g.integers(-(1 << 31), 1 << 31, size=(r, c), dtype=np.int32)
    p0, p1 = digits.db_digit_planes_np(d)
    want = matmul_u32.matmul_u32_np(a, d)
    assert np.array_equal(want, jax_mm.matmul_u32_np(a, d))
    t0, t1 = torch.from_numpy(p0), torch.from_numpy(p1)
    assert np.array_equal(_u32(matmul_u32.matmul_u32_x_db(_i32(a), t0, t1)), want)
    assert np.array_equal(np.asarray(jax_mm.matmul_u32_x_db(a, p0, p1)).view(np.uint32), want)
    got = matmul_u32.digit_matmul_accumulate(torch.from_numpy(acc), _i32(a), t0, t1)
    assert np.array_equal(got.numpy(), np.asarray(jax_mm.digit_matmul_accumulate(acc, a, p0, p1)))
    assert np.array_equal(_u32(got), want + acc.view(np.uint32))
    assert np.array_equal(_u32(respond.respond_batch(_i32(a), t0, t1)), np.asarray(jax_respond.respond_batch(a, p0, p1)))
    assert np.array_equal(respond.respond_batch_np(a, d), jax_respond.respond_batch_np(a, d))
    # planes padded for torch._int_mm on CUDA, as the server holds them: same answer, cut
    padded = matmul_u32.pad_plane(t0), matmul_u32.pad_plane(t1)
    assert padded[0].shape == (-(-k // 8) * 8, -(-c // 8) * 8)
    assert np.array_equal(_u32(respond.respond_batch(_i32(a), *padded)[:, :c]), want)


@settings(max_examples=15, deadline=None)
@given(r=st.integers(1, 12), k=st.integers(1, 300), c=st.integers(1, 20), seed=st.integers(0, 2**32 - 1))
def test_digit_matmul_full_matches_jax(r, k, c, seed):
    from chalametpir_tpu.ops.matmul_u32 import digit_matmul_full as jax_full

    g = np.random.default_rng(seed)
    a, b = _words(g, (r, k)), _words(g, (k, c))
    ad, bd = digits.recode_u32_np(a), digits.recode_u32_np(b)
    got = _u32(matmul_u32.digit_matmul_full(torch.from_numpy(ad), torch.from_numpy(bd), r))
    assert np.array_equal(got, matmul_u32.matmul_u32_np(a, b))
    assert np.array_equal(got, np.asarray(jax_full(ad, bd, r)).view(np.uint32))


def _extreme_case(device):
    """Every digit at -128 over more rows than one K_SPLIT piece: a single
    int32 accumulator over the whole K would pass 2^31."""
    k = 2 * matmul_u32.K_SPLIT + 8
    assert 128 * 128 * k > 1 << 31
    a = np.full((3, k), 0x7F7F7F80, np.uint32)  # four digits of -128
    d = np.full((k, 8), 128, np.uint32)  # d0 = -128, d1 = 1
    p0, p1 = digits.db_digit_planes_np(d)
    assert (p0 == -128).all() and (p1 == 1).all() and (digits.recode_u32_np(a) == -128).all()
    want = matmul_u32.matmul_u32_np(a, d)
    got = matmul_u32.matmul_u32_x_db(_i32(a).to(device), torch.from_numpy(p0).to(device),
                                     torch.from_numpy(p1).to(device))
    assert np.array_equal(_u32(got), want)
    ad = torch.full((4, 3, k), -128, dtype=torch.int8, device=device)
    bd = torch.full((4, k, 8), -128, dtype=torch.int8, device=device)
    word = np.uint64(0x7F7F7F80)
    full = _u32(matmul_u32.digit_matmul_full(ad, bd, 3))
    assert (full == np.uint32((int(word) * int(word) * k) % (1 << 32))).all()
    return a, p0, p1, want


def test_products_are_exact_across_a_k_split_at_extreme_digits():
    from chalametpir_tpu.ops.matmul_u32 import matmul_u32_x_db as jax_x_db

    a, p0, p1, want = _extreme_case("cpu")
    assert np.array_equal(np.asarray(jax_x_db(a, p0, p1)).view(np.uint32), want)


@pytest.mark.parametrize("case", ["k_mismatch", "plane_mismatch", "np_mismatch", "empty_k"])
def test_product_shapes_are_checked(case):
    a = torch.zeros((2, 16), dtype=torch.int32)
    d = torch.zeros((16, 8), dtype=torch.int8)
    if case == "k_mismatch":
        with pytest.raises(ValueError):
            matmul_u32.matmul_u32_x_db(torch.zeros((2, 17), dtype=torch.int32), d, d)
    elif case == "plane_mismatch":
        with pytest.raises(ValueError):
            matmul_u32.matmul_u32_x_db(a, d, torch.zeros((16, 9), dtype=torch.int8))
    elif case == "np_mismatch":
        with pytest.raises(IncompatibleDimensionForMatrixMultiplication):
            matmul_u32.matmul_u32_np(np.zeros((2, 3), np.uint32), np.zeros((4, 2), np.uint32))
    else:
        out = matmul_u32.matmul_u32_x_db(torch.zeros((2, 0), dtype=torch.int32), d[:0], d[:0])
        assert out.shape == (2, 8) and not out.any()


@pytest.mark.parametrize("m,c", [(300, 77), (64, 8)])
def test_digit_planes_on_a_device_hold_the_host_planes(m, c, rng):
    d = rng.integers(0, 1 << 13, size=(m, c), dtype=np.uint16)
    planes = respond.build_digit_planes(d, 13, "cpu")
    p0, p1 = digits.db_digit_planes_np(d)
    assert planes.d0.shape == planes.d1.shape == (-(-m // 8) * 8, -(-c // 8) * 8)
    assert np.array_equal(planes.d0[:m, :c].numpy(), p0) and np.array_equal(planes.d1[:m, :c].numpy(), p1)
    assert not planes.d0[m:].any() and not planes.d0[:, c:].any() and not planes.d1[m:].any()
    again = respond.digit_planes_from_host(p0, p1, 13, "cpu")
    assert torch.equal(again.d0, planes.d0) and torch.equal(again.d1, planes.d1)
    assert (planes.num_rows, planes.num_cols, planes.mat_elem_bit_len) == (m, c, 13)
    assert planes.device_bytes == 2 * planes.d0.numel() and planes.device.type == "cpu"


# -- the card against the CPU plain run ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,c", [(1, 70003, 13), (5, 131080, 940), (40, 3000, 64), (17, 65537, 8), (64, 4096, 1024)])
def test_cuda_products_equal_the_cpu_run(r, k, c, cuda):
    g = np.random.default_rng(r * k + c)
    a = _words(g, (r, k))
    d = g.integers(0, 1 << 14, size=(k, c), dtype=np.uint32)
    t0, t1 = _planes(d)
    want = matmul_u32.matmul_u32_x_db(_i32(a), t0, t1)
    for planes in ((t0, t1), (matmul_u32.pad_plane(t0), matmul_u32.pad_plane(t1))):
        got = respond.respond_batch(_i32(a).to(cuda), planes[0].to(cuda), planes[1].to(cuda))
        assert got.device.type == "cuda" and torch.equal(got.cpu()[:, :c], want)
    acc = torch.from_numpy(g.integers(-(1 << 31), 1 << 31, size=(r, c), dtype=np.int32))
    got = matmul_u32.digit_matmul_accumulate(acc.to(cuda), _i32(a).to(cuda), t0.to(cuda), t1.to(cuda))
    assert torch.equal(got.cpu(), acc + want)
    ad, bd = digits.recode_u32_np(a[:, :2000]), digits.recode_u32_np(_words(g, (2000, c)))
    full = matmul_u32.digit_matmul_full(torch.from_numpy(ad).to(cuda), torch.from_numpy(bd).to(cuda), r)
    assert torch.equal(full.cpu(), matmul_u32.digit_matmul_full(torch.from_numpy(ad), torch.from_numpy(bd), r))


@pytest.mark.cuda
def test_cuda_products_are_exact_across_a_k_split_at_extreme_digits(cuda):
    _extreme_case(cuda)


@pytest.mark.cuda
def test_cuda_recode_and_planes_equal_the_cpu_run(cuda):
    x = _i32(EDGES)
    assert torch.equal(digits.recode_u32(x.to(cuda)).cpu(), digits.recode_u32(x))
    d = np.random.default_rng(3).integers(0, 1 << 14, size=(70000, 77), dtype=np.uint16)
    on_card, on_host = respond.build_digit_planes(d, 14, cuda), respond.build_digit_planes(d, 14, "cpu")
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.d0.cpu(), on_host.d0) and torch.equal(on_card.d1.cpu(), on_host.d1)
