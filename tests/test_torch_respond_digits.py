"""The port's digit-layout respond (chalametpir_tpu_torch/ops/respond_digits.py)
against the JAX package's Pallas kernels that take int8 query digits, run
interpreted on the CPU: `_run_lo_only` / `_run_with_hi`
(chalametpir_tpu/ops/respond_pallas.py), which read the strided 2-D
layout, and the scan diagnostics' 3-D-layout kernels, reproduced below;
and the recombined digit respond against the port's u32 respond and the
JAX `respond_batch_packed`. Every output is an int32 mod 2^32: the
tolerance is exact equality.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

from functools import partial

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch.ops import digits
from chalametpir_tpu_torch.ops import respond_digits as rd
from chalametpir_tpu_torch.ops import respond_packed as rp

# the tensors here are small: one intra-op thread per test worker keeps
# parallel workers from oversubscribing the cores
torch.set_num_threads(1)

BITS = [8, 9, 10, 12, 14]
PACKS = [0, 1, 2, 4, 8]
TILE_K = 256
M_PAD, C_PAD = 3 * TILE_K, 256
M, C = 700, 150  # not multiples of any tile


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _i32(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


def _random_planes(g: np.random.Generator, pack: int, m_pad: int = M_PAD, c_pad: int = C_PAD):
    """Unstructured plane bytes: every lo byte and every hi byte, also
    those a served plane never holds (pack 1 bytes >= 128)."""
    lo = g.integers(-128, 128, size=(m_pad, c_pad), dtype=np.int8)
    pc = c_pad // pack if pack > 1 else c_pad
    hi = g.integers(0, 256, size=(m_pad, pc), dtype=np.uint8) if pack else None
    return lo, hi


def _bits(pack: int) -> int:
    return 8 // pack if pack > 1 else 8


def _ref(qd: np.ndarray, lo: np.ndarray, hi, pack: int, layout: str):
    qt = torch.from_numpy(qd)
    if layout == "3d":
        qt = rd.to_3d(qt, TILE_K)
    return rd.respond_digits_ref(qt, torch.from_numpy(lo), torch.from_numpy(hi) if pack else None, pack)


# -- the scan diagnostics' 3-D-layout Pallas kernels, reproduced -----------
# `_k3d_lo`, `_k3d_hi`, `run3d_lo` and `run3d_hi` are closures inside
# main() of scripts/diag_scan_qdsweep.py (:45, :57, :79, :93), so they
# cannot be imported; these are their bodies verbatim, with the
# interpreter switched on. scripts/diag_scan_qdlayout.py `_kernel_q3d` /
# `run_q3d` (:42, :55) are the same as `_k3d_lo` / `run3d_lo`.


def _k3d_lo(qd_ref, lo_ref, out_ref):
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    i = pl.program_id(0)
    p = jnp.dot(qd_ref[0], lo_ref[:], preferred_element_type=jnp.int32)

    @pl.when(i == 0)
    def _():
        out_ref[:] = p

    @pl.when(i > 0)
    def _():
        out_ref[:] = out_ref[:] + p


def _k3d_hi(pack, bits, qd_ref, lo_ref, hi_ref, out_lo_ref, out_hi_ref):
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    i = pl.program_id(0)
    qd = qd_ref[0]
    p_lo = jnp.dot(qd, lo_ref[:], preferred_element_type=jnp.int32)
    hp = hi_ref[:].astype(jnp.int32)
    mask = (1 << bits) - 1
    parts = [((hp >> (bits * j)) & mask).astype(jnp.int8) for j in range(pack)]
    hi = jnp.concatenate(parts, axis=1)
    p_hi = jnp.dot(qd[: out_hi_ref.shape[0], :], hi, preferred_element_type=jnp.int32)

    @pl.when(i == 0)
    def _():
        out_lo_ref[:] = p_lo
        out_hi_ref[:] = p_hi

    @pl.when(i > 0)
    def _():
        out_lo_ref[:] = out_lo_ref[:] + p_lo
        out_hi_ref[:] = out_hi_ref[:] + p_hi


def _run3d_lo(qd3, lo, tile_k):
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    n_tiles, qd_rows, _ = qd3.shape
    return pl.pallas_call(
        _k3d_lo,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((1, qd_rows, tile_k), lambda i: (i, 0, 0)),
            pl.BlockSpec((tile_k, lo.shape[1]), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((qd_rows, lo.shape[1]), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((qd_rows, lo.shape[1]), jnp.int32),
        interpret=True,
    )(qd3, lo)


def _run3d_hi(qd3, lo, hi, tile_k, pack, bits):
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    n_tiles, qd_rows, _ = qd3.shape
    c_pad, pc = lo.shape[1], hi.shape[1]
    qh_rows = qd_rows - qd_rows // 4
    return pl.pallas_call(
        partial(_k3d_hi, pack, bits),
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((1, qd_rows, tile_k), lambda i: (i, 0, 0)),
            pl.BlockSpec((tile_k, c_pad), lambda i: (i, 0)),
            pl.BlockSpec((tile_k, pc), lambda i: (i, 0)),
        ],
        out_specs=[
            pl.BlockSpec((qd_rows, c_pad), lambda i: (0, 0)),
            pl.BlockSpec((qh_rows, c_pad), lambda i: (0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((qd_rows, c_pad), jnp.int32),
            jax.ShapeDtypeStruct((qh_rows, c_pad), jnp.int32),
        ],
        interpret=True,
    )(qd3, lo, hi)


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("pack", PACKS)
def test_ref_matches_respond_pallas_2d(pack, rows, rng):
    """Raw outputs, both layouts, against K1/K2 fed the 2-D digits."""
    from chalametpir_tpu.ops.respond_pallas import _run_lo_only, _run_with_hi

    lo, hi = _random_planes(rng, pack)
    qd = rng.integers(-128, 128, size=(rows, M_PAD), dtype=np.int8)
    if pack:
        want = [np.asarray(o) for o in _run_with_hi(qd, lo, hi, TILE_K, pack, _bits(pack), True)]
    else:
        want = [np.asarray(_run_lo_only(qd, lo, TILE_K, True))]
    for layout in rd.LAYOUTS:
        out_lo, out_hi = _ref(qd, lo, hi, pack, layout)
        assert out_lo.shape == (rows, C_PAD) and out_lo.dtype == torch.int32
        assert np.array_equal(out_lo.numpy(), want[0])
        if pack:
            assert out_hi.shape == (rows - rows // 4, C_PAD)
            assert np.array_equal(out_hi.numpy(), want[1])
        else:
            assert out_hi is None


@pytest.mark.parametrize("pack", PACKS)
def test_ref_matches_diag_3d_kernels(pack, rng):
    """Raw outputs against the diagnostics' own 3-D kernels (K4/K5 lo only,
    K6 with hi) fed the materialised 3-D digits."""
    lo, hi = _random_planes(rng, pack)
    qd = rng.integers(-128, 128, size=(32, M_PAD), dtype=np.int8)
    # the diagnostics' relayout: qd2.reshape(32, n_tiles, tile_k).transpose(1, 0, 2)
    qd3 = np.ascontiguousarray(qd.reshape(32, M_PAD // TILE_K, TILE_K).transpose(1, 0, 2))
    assert np.array_equal(rd.to_3d(torch.from_numpy(qd), TILE_K).numpy(), qd3)
    out_lo, out_hi = _ref(qd, lo, hi, pack, "3d")
    if pack:
        want_lo, want_hi = _run3d_hi(qd3, lo, hi, TILE_K, pack, _bits(pack))
        assert np.array_equal(out_hi.numpy(), np.asarray(want_hi))
    else:
        want_lo = _run3d_lo(qd3, lo, TILE_K)
    assert np.array_equal(out_lo.numpy(), np.asarray(want_lo))


@pytest.mark.parametrize("b", BITS)
def test_composed_matches_u32_respond_and_jax(b, rng):
    """Digits, digit products and recombination give the u32 respond's
    words, for 32 and 64 digit rows, in both layouts."""
    from chalametpir_tpu.ops.respond_pallas import build_pallas_db, respond_batch_packed

    mat = rng.integers(0, 1 << b, size=(M, C), dtype=np.uint32)
    queries = rng.integers(0, 1 << 32, size=(9, M), dtype=np.uint32)
    want = np.asarray(respond_batch_packed(queries, build_pallas_db(mat, b, tile_k=TILE_K), interpret=True))
    db = rp.build_packed_db(mat, b, "cpu")
    for q in (8, 9):  # 32 and 64 digit rows
        u32 = rp.respond_packed_ref(_i32(queries[:q]), db.lo, db.hi, b, C)
        assert np.array_equal(u32.numpy().view(np.uint32), want[:q])
        for layout in rd.LAYOUTS:
            got = rd.respond_batch_digits(_i32(queries[:q]), db, layout)
            assert got.shape == (q, C)
            assert torch.equal(got, u32)


def test_to_3d_is_materialised(rng):
    qd = torch.from_numpy(rng.integers(-128, 128, size=(32, 4 * TILE_K), dtype=np.int8))
    qd3 = rd.to_3d(qd, TILE_K)
    assert qd3.shape == (4, 32, TILE_K) and qd3.is_contiguous()
    assert qd3.stride() == (32 * TILE_K, TILE_K, 1)
    assert torch.equal(qd3[2, 5], qd[5, 2 * TILE_K : 3 * TILE_K])
    with pytest.raises(ValueError):
        rd.to_3d(qd[:, :-4], TILE_K)


def test_wrapper_checks(rng):
    lo, hi = _random_planes(rng, 8)
    qd = torch.from_numpy(rng.integers(-128, 128, size=(32, M_PAD), dtype=np.int8))
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    out = rd.respond_digits(qd, lo_t, hi_t, 8)  # CPU planes: the plain version
    ref = rd.respond_digits_ref(qd, lo_t, hi_t, 8)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    with pytest.raises(ValueError):
        rd.respond_digits(qd.to("meta"), lo_t, hi_t, 8)
    db = rp.build_packed_db(rng.integers(0, 512, size=(M, C), dtype=np.uint32), 9, "cpu")
    queries = _i32(rng.integers(0, 1 << 32, size=(2, M), dtype=np.uint32))
    with pytest.raises(ValueError):
        rd.respond_batch_digits(queries, db, "1d")
    with pytest.raises(ValueError):
        rd.respond_batch_digits(queries[:, :-1], db, "3d")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", rd.LAYOUTS)
@pytest.mark.parametrize("rows", [32, 64, 256])
@pytest.mark.parametrize("pack", PACKS)
def test_digit_kernel_matches_plain(pack, rows, layout, cuda):
    from chalametpir_tpu_torch import kernels

    g = np.random.default_rng(100 * pack + rows)
    lo, hi = _random_planes(g, pack, m_pad=30 * 1024, c_pad=1024)
    lo_t = torch.from_numpy(lo).to(cuda)
    hi_t = torch.from_numpy(hi).to(cuda) if pack else None
    qd = torch.from_numpy(g.integers(-128, 128, size=(rows, lo.shape[0]), dtype=np.int8)).to(cuda)
    want = rd.respond_digits_ref(qd, lo_t, hi_t, pack)
    before = kernels.LAUNCHES["respond_digits"]
    got = rd.respond_digits(qd if layout == "2d" else rd.to_3d(qd, 1024), lo_t, hi_t, pack)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["respond_digits"] == before + 1
    assert torch.equal(got[0], want[0])
    if pack:
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_digit_kernel_reads_through_strides(cuda):
    """A permuted (non-contiguous) 3-D view reads the 2-D memory: same
    numbers, through the tile and row strides."""
    g = np.random.default_rng(7)
    lo, hi = _random_planes(g, 4, m_pad=8 * 2048, c_pad=512)
    lo_t, hi_t = torch.from_numpy(lo).to(cuda), torch.from_numpy(hi).to(cuda)
    qd = torch.from_numpy(g.integers(-128, 128, size=(32, lo.shape[0]), dtype=np.int8)).to(cuda)
    view3 = qd.reshape(32, 8, 2048).permute(1, 0, 2)
    assert not view3.is_contiguous()
    got = rd.respond_digits(view3, lo_t, hi_t, 4)
    want = rd.respond_digits(qd, lo_t, hi_t, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b", BITS)
def test_composed_kernel_matches_u32_kernel(b, cuda):
    g = np.random.default_rng(b)
    m, c = 30001, 1000
    mat = g.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    db = rp.build_packed_db(mat, b, cuda)
    for q in (1, 8, 16, 64):
        queries = _i32(g.integers(0, 1 << 32, size=(q, m), dtype=np.uint32), cuda)
        want = rp.respond_batch_packed(queries, db)
        for layout in rd.LAYOUTS:
            assert torch.equal(rd.respond_batch_digits(queries, db, layout), want)


@pytest.mark.cuda
def test_scan_check_on_the_card(cuda):
    """The scan diagnostic's checks at a small geometry, on the card."""
    from chalametpir_tpu_torch.diag import scan_qd

    g = torch.Generator(device=cuda).manual_seed(3)
    for geo in (scan_qd.Geometry(0, 9, 20000, 940), scan_qd.Geometry(0, 8, 20000, 1057)):
        db = scan_qd.synthetic_planes(geo, cuda, g)
        queries = torch.randint(-(1 << 31), 1 << 31, (8, geo.m), dtype=torch.int32, device=cuda,
                                generator=g)
        scan_qd.check(db, queries)
