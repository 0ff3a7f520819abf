"""The port's packed respond and hint fold
(chalametpir_tpu_torch/ops/respond_packed.py) against the JAX package's
Pallas kernels (ops/respond_pallas.py, run interpreted on the CPU) and a
numpy uint64 oracle. Every value is a u32 mod 2^32: the tolerance is
exact equality.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch.ops import respond_packed as rp

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

BITS = [4, 8, 9, 10, 12, 13, 14]
M, C = 700, 150  # not multiples of any tile


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _oracle(queries: np.ndarray, mat: np.ndarray) -> np.ndarray:
    return (queries.astype(np.uint64) @ mat.astype(np.uint64)).astype(np.uint32)


def _i32(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().numpy().view(np.uint32)


def _inputs(seed: int, b: int, q: int, m: int = M, c: int = C):
    g = np.random.default_rng(seed)
    queries = g.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    mat = g.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    return queries, mat


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("b", BITS)
def test_plane_bytes_match_jax(b, dtype, rng):
    from chalametpir_tpu.ops.respond_pallas import build_pallas_db

    mat = rng.integers(0, 1 << b, size=(M, C)).astype(dtype)
    port = rp.build_packed_db(mat, b, "cpu")
    ref = build_pallas_db(mat, b)
    assert np.array_equal(port.lo.numpy(), np.asarray(ref.lo))
    if ref.hi is None:
        assert port.hi is None
    else:
        assert np.array_equal(port.hi.numpy(), np.asarray(ref.hi))
    assert (port.num_rows, port.num_cols) == (M, C)


@pytest.mark.parametrize("q", [1, 5, 64])
@pytest.mark.parametrize("b", BITS)
def test_respond_ref_matches_oracle(b, q, rng):
    queries, mat = _inputs(int(rng.integers(1 << 30)), b, q)
    db = rp.build_packed_db(mat, b, "cpu")
    got = rp.respond_batch_packed(_i32(queries), db)
    assert got.shape == (q, C)
    assert np.array_equal(_u32(got), _oracle(queries, mat))


@pytest.mark.parametrize("b", BITS)
def test_respond_matches_jax_pallas(b, rng):
    """64 queries through the JAX Pallas kernel (interpreted); the port's
    answers to the first 1, 5 and 64 of them are the matching rows."""
    from chalametpir_tpu.ops.respond_pallas import build_pallas_db, respond_batch_packed

    queries, mat = _inputs(int(rng.integers(1 << 30)), b, 64)
    want = np.asarray(respond_batch_packed(queries, build_pallas_db(mat, b, tile_k=256), interpret=True))
    db = rp.build_packed_db(mat, b, "cpu")
    for q in (1, 5, 64):
        assert np.array_equal(_u32(rp.respond_batch_packed(_i32(queries[:q]), db)), want[:q])


@pytest.mark.parametrize("b", [8, 9, 12])
def test_hint_fold_partial_matches_jax(b, rng):
    """All 1792 (K_PAD) A rows in one fold, read fingerprint-major, equal
    the JAX package's 14 interpreted 128-row groups over the transpose."""
    from chalametpir_tpu.ops import respond_pallas

    cc, k_pad = 512, 1792
    a_slab = rng.integers(0, 1 << 32, size=(cc, k_pad), dtype=np.uint32)
    mat = rng.integers(0, 1 << b, size=(cc, C), dtype=np.uint32)
    jdb = respond_pallas.build_pallas_db(mat, b, tile_k=256)
    want = np.asarray(respond_pallas.hint_fold_partial(
        np.ascontiguousarray(a_slab.T), jdb.lo, jdb.hi, b, C, 256, 128, True
    ))
    db = rp.build_packed_db(mat, b, "cpu")
    got = rp.hint_fold_partial(_i32(a_slab).t(), db.lo[:cc], db.hi[:cc] if db.hi is not None else None, b, C)
    assert np.array_equal(_u32(got), want)
    assert np.array_equal(_u32(got), _oracle(a_slab.T, mat))

    # with `out`, chunks accumulate mod 2^32 into one buffer
    out = torch.zeros((k_pad, db.lo.shape[1]), dtype=torch.int32)
    for _ in range(2):
        rp.hint_fold_partial(_i32(a_slab).t(), db.lo[:cc], db.hi[:cc] if db.hi is not None else None, b, C, out=out)
    assert np.array_equal(_u32(out[:, :C]), want * np.uint32(2))


def test_respond_rejects_query_length(rng):
    queries, mat = _inputs(1, 9, 2)
    db = rp.build_packed_db(mat, 9, "cpu")
    with pytest.raises(ValueError):
        rp.respond_batch_packed(_i32(queries[:, :-1]), db)


@pytest.mark.parametrize("q", [1, 16, 64])
@pytest.mark.parametrize("b", [8, 9, 10, 12, 14])
def test_mma_arithmetic_matches_ref_and_jax(b, q, rng):
    """The tensor-core regime's arithmetic (balanced digits x u8 low bytes,
    digits 0-2 x hi fields, 2^(8d) scaling, int32 partials per row split)
    in plain torch against the plain version and the JAX Pallas kernel
    (interpreted), with splits that cut the rows unevenly."""
    from chalametpir_tpu.ops.respond_pallas import build_pallas_db, respond_batch_packed

    queries, mat = _inputs(int(rng.integers(1 << 30)), b, q)
    db = rp.build_packed_db(mat, b, "cpu")
    want = rp.respond_packed_ref(_i32(queries), db.lo, db.hi, b, C)
    jax_want = np.asarray(respond_batch_packed(queries, build_pallas_db(mat, b, tile_k=256), interpret=True))
    assert np.array_equal(_u32(want), jax_want)
    for split_rows in (64, 256 + 64, 1 << 16):
        got = rp.respond_packed_mma_arith(_i32(queries), db.lo, db.hi, b, C, split_rows)
        assert torch.equal(got, want)


def test_mma_split_bound_keeps_int32():
    """At the kernel's largest split, the extreme digit (-128) against the
    extreme low byte (255) on every row still fits the s32 accumulator;
    2^31 / (128 x 255) rows, rounded up, would not."""
    from chalametpir_tpu_torch import kernels

    rows = kernels.MMA_MAX_SPLIT_ROWS
    over = -(-(1 << 31) // (128 * 255)) + 1
    queries = torch.full((1, over), 0x80, dtype=torch.int32)  # digit 0 == -128
    lo = torch.full((over, 128), 127, dtype=torch.int8)  # u8 low byte 255
    got = rp.respond_packed_mma_arith(queries[:, :rows], lo[:rows], None, 8, 128)
    assert torch.equal(got, rp.respond_packed_ref(queries[:, :rows], lo[:rows], None, 8, 128))
    with pytest.raises(OverflowError):
        rp.respond_packed_mma_arith(queries, lo, None, 8, 128, split_rows=over)


def test_balanced_digits_match_jax_recode(rng):
    from chalametpir_tpu.ops.digits import recode_u32_np

    x = rng.integers(0, 1 << 32, size=(3, 257), dtype=np.uint32)
    x[0, :4] = [0, 0x7F7F7F7F, 0x80808080, 0xFFFFFFFF]
    got = rp.balanced_digits(_i32(x)).numpy()
    assert np.array_equal(got, np.asarray(recode_u32_np(x)).astype(np.int64))


@pytest.mark.parametrize(
    "nq, pack, regime",
    [(1, 8, "scan"), (1, 1, "scan"), (2, 8, "mma"), (16, 4, "mma"), (1774, 2, "mma"),
     (1, 0, "mma"), (2, 0, "mma")],
)
def test_regime_choice(nq, pack, regime):
    """The scan serves one query over planes with a hi plane; the tensor
    cores serve everything else, a lo plane alone even at one query."""
    from chalametpir_tpu_torch import kernels

    assert kernels.MMA_MIN_Q == 2
    assert kernels.choose_regime(nq, pack) == regime


@pytest.mark.parametrize("nq, by", [(1, "bytes"), (16, "bytes"), (64, "operations"), (1774, "operations")])
def test_respond_bound_is_the_cards_peak(nq, by):
    """The respond bound of the served 2^20 planes (b = 9) reckons with the
    H100's published 3.35 TB/s and 1,979 int8 TOP/s, not a measured rate."""
    from chalametpir_tpu_torch.diag.respond_regimes import bound_ms

    m, c_pad, planes = 1_179_648, 1024, 1_207_959_552 + 150_994_944
    ms, got_by = bound_ms(nq, m, c_pad, planes, 9)
    by_bytes = (planes + 4 * nq * m + 4 * nq * c_pad) / 3.35e12 * 1e3
    by_ops = 2 * 7 * nq * m * c_pad / 1.979e15 * 1e3
    assert got_by == by
    assert ms == pytest.approx(max(by_bytes, by_ops), rel=1e-12)


@pytest.mark.parametrize("log_n, first_row, pack", [(20, 0, 8), (23, 71 << 17, 0)])
def test_respond_regimes_folds_the_setups_chunk(log_n, first_row, pack):
    """The diagnostic's fold row takes a chunk as the ctr setup cuts it: the
    first of the 2^20 planes (b = 9, a hi plane), the last of the 2^23 lo
    plane (b = 8, pack 0: K2's work), whose view starts past 2^32 bytes."""
    from chalametpir_tpu_torch.diag.respond_regimes import HEIGHTS, LAST_FOLD_CHUNK, fold_chunk
    from chalametpir_tpu_torch.diag.scan_qd import Geometry

    assert set(LAST_FOLD_CHUNK) == set(HEIGHTS)
    geo = Geometry.of(log_n)
    r0, rows = fold_chunk(geo, LAST_FOLD_CHUNK[log_n])
    assert (r0, rows) == (first_row, 1 << 17) and r0 + rows <= geo.m_pad
    assert rp.pack_geometry(geo.b, geo.c_pad)[0] == pack
    assert (r0 * geo.c_pad > 1 << 32) == (log_n == 23)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 2, 5, 8, 15, 16, 17, 64, 1774])
@pytest.mark.parametrize("b", BITS)
def test_respond_kernel_matches_plain(b, q, cuda):
    from chalametpir_tpu_torch import kernels

    queries, mat = _inputs(1000 * b + q, b, q)
    db = rp.build_packed_db(mat, b, cuda)
    # b <= 8 (pack 0) takes the tensor cores even at Q = 1
    name = f"respond_packed_{kernels.choose_regime(q, rp.pack_geometry(b, db.lo.shape[1])[0])}"
    before = kernels.LAUNCHES[name]
    got = rp.respond_batch_packed(_i32(queries, cuda), db)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = rp.respond_packed_ref(_i32(queries, cuda), db.lo, db.hi, b, C)
    assert torch.equal(got, want)
    assert np.array_equal(_u32(got), _oracle(queries, mat))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["scan", "mma"])
@pytest.mark.parametrize("b", [8, 9, 10, 12, 14])
def test_respond_regimes_match_plain_across_the_crossover(b, regime, cuda):
    """Both regimes on both sides of MMA_MIN_Q, every pack, with a long
    enough m that the rows split, and out accumulated into twice."""
    from chalametpir_tpu_torch import kernels

    m = 70001
    for q in (kernels.MMA_MIN_Q - 1, kernels.MMA_MIN_Q):
        queries, mat = _inputs(77 * b + q, b, q, m=m)
        db = rp.build_packed_db(mat, b, cuda)
        qt = _i32(queries, cuda)
        want = rp.respond_packed_ref(qt, db.lo, db.hi, b, C)
        out = torch.zeros((q, db.lo.shape[1]), dtype=torch.int32, device=cuda)
        pack = rp.pack_geometry(b, db.lo.shape[1])[0]
        for _ in range(2):
            kernels._respond_packed(qt, db.lo, db.hi, pack, out, regime)
        assert torch.equal(out[:, :C], rp._wrap_i32(2 * want.to(torch.int64)))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 9, 12])
def test_hint_fold_kernel_matches_plain(b, cuda):
    g = np.random.default_rng(b)
    cc, k = 2048 + 96, 1774
    a_slab = g.integers(0, 1 << 32, size=(cc, k), dtype=np.uint32)
    mat = g.integers(0, 1 << b, size=(cc, C), dtype=np.uint32)
    db = rp.build_packed_db(mat, b, cuda)
    out = torch.zeros((k, db.lo.shape[1]), dtype=torch.int32, device=cuda)
    for _ in range(2):
        rp.hint_fold_partial(_i32(a_slab, cuda).t(), db.lo, db.hi, b, C, out=out)
    assert np.array_equal(_u32(out[:, :C]), _oracle(a_slab.T, mat) * np.uint32(2))
