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
from hypothesis import given
from hypothesis import settings as hyp_settings
from hypothesis import strategies as st

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
    # the kernel's launcher takes CUDA tensors only: no plain version behind it
    from chalametpir_tpu_torch import kernels

    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.respond_digits(qd, lo_t, hi_t, 8, torch.zeros(32, C_PAD, dtype=torch.int32),
                               torch.zeros(24, C_PAD, dtype=torch.int32))


# -- the digit kernel's host side: contract, launch geometry, build key -----


def _launch_args(pack=8, rows=32, m=M_PAD, c_pad=C_PAD, layout="2d", device="cpu"):
    """Zero tensors that meet the digit kernel's contract (the checks read
    shapes, strides, types and addresses only, on any device)."""
    qd = torch.zeros((rows, m), dtype=torch.int8, device=device)
    if layout == "3d":
        qd = rd.to_3d(qd, TILE_K)
    pc = c_pad // pack if pack > 1 else c_pad
    return {
        "qd": qd, "lo": torch.zeros((m, c_pad), dtype=torch.int8, device=device),
        "hi": torch.zeros((m, pc), dtype=torch.uint8, device=device) if pack else None, "pack": pack,
        "out_lo": torch.zeros((rows, c_pad), dtype=torch.int32, device=device),
        "out_hi": torch.zeros((rows - rows // 4, c_pad), dtype=torch.int32, device=device) if pack else None,
    }


def test_launch_args_of_both_layouts():
    from chalametpir_tpu_torch import kernels

    assert kernels.digit_launch_args(**_launch_args()) == (32, M_PAD, M_PAD, 0, M_PAD, C_PAD, C_PAD // 8)
    # a 2-D length that is no whole stage: one tile of whole stages holds it
    assert kernels.digit_launch_args(**_launch_args(pack=0, m=M_PAD - 16))[:4] == (32, M_PAD - 16, M_PAD, 0)
    assert kernels.digit_launch_args(**_launch_args(pack=1, rows=96, layout="3d")) == (
        96, M_PAD, TILE_K, 96 * TILE_K, TILE_K, C_PAD, C_PAD)
    args = _launch_args(pack=4)
    args["qd"] = args["qd"].reshape(32, 3, TILE_K).permute(1, 0, 2)  # a 3-D view of the 2-D memory
    assert kernels.digit_launch_args(**args)[:5] == (32, M_PAD, TILE_K, TILE_K, M_PAD)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A tensor like t, on its device, 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 32, dtype=t.dtype, device=t.device)
    off = next(o for o in range(1, 17) if (flat.data_ptr() + o * t.element_size()) % 16 == 4)
    return flat[off : off + t.numel()].view(t.shape)


def _like(a: dict, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=a["lo"].device)


VIOLATIONS = {
    "qd_rows not a multiple of 32": lambda a: a.update(qd=a["qd"][:24], out_lo=a["out_lo"][:24], out_hi=a["out_hi"][:18]),
    "m not a multiple of 16": lambda a: a.update(qd=a["qd"][:, : M_PAD - 8]),
    "2-D column stride": lambda a: a.update(qd=_like(a, (32, 2 * M_PAD), torch.int8)[:, ::2]),
    "2-D row stride not a multiple of 16": lambda a: a.update(qd=_like(a, (32, M_PAD + 8), torch.int8)[:, :M_PAD]),
    "3-D tile_k not a multiple of 64": lambda a: a.update(qd=a["qd"].reshape(32, M_PAD // 32, 32).permute(1, 0, 2).contiguous()),
    "3-D inner stride": lambda a: a.update(qd=_like(a, (3, 32, 2 * TILE_K), torch.int8)[:, :, ::2]),
    "1-D digits": lambda a: a.update(qd=a["qd"].reshape(-1)),
    "digits int32": lambda a: a.update(qd=a["qd"].to(torch.int32)),
    "digits misaligned": lambda a: a.update(qd=_misaligned(a["qd"])),
    "lo misaligned": lambda a: a.update(lo=_misaligned(a["lo"])),
    "hi misaligned": lambda a: a.update(hi=_misaligned(a["hi"])),
    "lo shorter than the digits": lambda a: a.update(lo=a["lo"][:-1], hi=a["hi"][:-1]),
    "lo not contiguous": lambda a: a.update(lo=_like(a, (M_PAD, 2 * C_PAD), torch.int8)[:, :C_PAD]),
    "c_pad not a multiple of 128": lambda a: a.update(lo=_like(a, (M_PAD, 192), torch.int8)),
    "lo uint8": lambda a: a.update(lo=a["lo"].view(torch.uint8)),
    "pack 3": lambda a: a.update(pack=3),
    "hi missing": lambda a: a.update(hi=None),
    "hi of another pack": lambda a: a.update(hi=_like(a, (M_PAD, C_PAD // 4), torch.uint8)),
    "hi int8": lambda a: a.update(hi=a["hi"].view(torch.int8)),
    "out_lo shape": lambda a: a.update(out_lo=a["out_lo"][:, :-1]),
    "out_lo int64": lambda a: a.update(out_lo=a["out_lo"].to(torch.int64)),
    "out_hi missing": lambda a: a.update(out_hi=None),
    "out_hi with qd_rows rows": lambda a: a.update(out_hi=_like(a, (32, C_PAD), torch.int32)),
}


@pytest.mark.parametrize("what", list(VIOLATIONS))
def test_launch_args_contract(what):
    from chalametpir_tpu_torch import kernels

    args = _launch_args()
    kernels.digit_launch_args(**args)  # the starting point is within the contract
    VIOLATIONS[what](args)
    with pytest.raises(ValueError):
        kernels.digit_launch_args(**args)


def _check_geometry(geo, m, qd_rows, c_pad, pack):
    from chalametpir_tpu_torch import kernels

    # the splits cover [0, m) exactly once, the last one not empty
    assert geo.splits >= 1 and (geo.splits - 1) * geo.rows_per_split < m <= geo.splits * geo.rows_per_split
    assert geo.rows_per_split % kernels.DIGIT_ROW_STEP == 0
    # |digit| <= 128, |plane byte| <= 255: no s32 accumulator of a split overflows
    assert geo.rows_per_split <= kernels.MMA_MAX_SPLIT_ROWS and 128 * 255 * geo.rows_per_split < 1 << 31
    assert (geo.warps, geo.fields) in kernels.digit_tiles(pack) and 32 * geo.warps <= 1024
    assert geo.smem_bytes == kernels.digit_smem_bytes(pack, geo.warps, geo.fields) <= kernels.BLOCK_SMEM_MAX == 232_448
    # the column blocks cover every column: `fields` fields of w hi bytes each
    w = 32 * geo.warps // geo.fields
    seg = c_pad // pack if pack > 1 else c_pad
    assert w % 16 == 0 and geo.grid[1] == -(-seg // w) * (pack // geo.fields if pack > 1 else 1)
    assert geo.grid == (qd_rows // 32, geo.grid[1], geo.splits)
    assert geo.grid[0] < 1 << 31 and geo.grid[1] <= 65535 and geo.grid[2] <= 65535


@hyp_settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 1 << 24).map(lambda x: 16 * x), row_groups=st.integers(1, 256),
       c_blocks=st.integers(1, 16), pack=st.sampled_from(PACKS), sm_count=st.integers(1, 264),
       waves=st.integers(1, 4))
def test_geometry_properties(m, row_groups, c_blocks, pack, sm_count, waves):
    from chalametpir_tpu_torch import kernels

    qd_rows, c_pad = 32 * row_groups, 128 * c_blocks
    _check_geometry(kernels.digit_geometry(m, qd_rows, c_pad, pack, sm_count, waves=waves), m, qd_rows, c_pad, pack)


@pytest.mark.parametrize("pack", PACKS)
@pytest.mark.parametrize("m,qd_rows,c_pad", [(1_179_648, 32, 1024), (9_437_184, 32, 1152),
                                             (9_437_184, 8192, 1152), (64, 32, 128), (30_000, 96, 1152)])
def test_geometry_at_the_scan_shapes(m, qd_rows, c_pad, pack):
    """The scan diagnostic's heights, the widest digit block and the
    smallest launch, unasked and with every tile forced."""
    from chalametpir_tpu_torch import kernels

    _check_geometry(kernels.digit_geometry(m, qd_rows, c_pad, pack), m, qd_rows, c_pad, pack)
    for tile in kernels.digit_tiles(pack):
        geo = kernels.digit_geometry(m, qd_rows, c_pad, pack, tile=tile, waves=2)
        assert (geo.warps, geo.fields) == tile
        _check_geometry(geo, m, qd_rows, c_pad, pack)
    with pytest.raises(ValueError):
        kernels.digit_geometry(m, qd_rows, c_pad, pack, tile=(3, 1))  # 96 columns: no tile


def test_geometry_fills_the_card_in_whole_rounds():
    """At the scan diagnostic's shapes on a 132-SM card: one block per SM
    and slot at 2^20, and at 2^23, where a split may not pass 65,536 rows,
    two whole rounds of the slots."""
    from chalametpir_tpu_torch import kernels

    geo = kernels.digit_geometry(1_179_648, 32, 1024, 8, 132)
    assert (geo.warps, geo.fields, geo.grid) == (16, 4, (1, 2, 66))
    geo = kernels.digit_geometry(9_437_184, 32, 1152, 0, 132)
    assert (geo.warps, geo.grid) == (12, (1, 3, 176)) and 3 * 176 == 2 * (2 * 132)


def test_digest_covers_the_headers(tmp_path, monkeypatch):
    """The build key changes with a header's bytes: an edit of a .cuh
    rebuilds the library."""
    import shutil

    from chalametpir_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels._CSRC, csrc)
    assert {p.name for p in csrc.iterdir()} >= set(kernels.SOURCES + kernels.HEADERS)
    assert all(name.endswith(".cuh") for name in kernels.HEADERS) and kernels.HEADERS
    before = kernels._digest()
    monkeypatch.setattr(kernels, "_CSRC", str(csrc))
    assert kernels._digest() == before  # the same bytes elsewhere
    for name in kernels.HEADERS + kernels.SOURCES:
        with open(csrc / name, "ab") as f:
            f.write(b"// edited\n")
        after = kernels._digest()
        assert after != before, name
        before = after
    # every header a source includes is one the digest reads
    for name in kernels.SOURCES:
        for line in (csrc / name).read_text().splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in kernels.HEADERS


EDGE_CASES = {
    # name: (digit rows, c_pad, digit fill, lo fill, hi fill); None = random
    "rows96": (96, C_PAD, None, None, None),
    "c_pad1152": (32, 1152, None, None, None),
    "min x min": (32, 128, -128, -128, 0xFF),
    "min x max": (32, 128, -128, 127, 0xFF),
    "max x min": (32, 128, 127, -128, 0xFF),
    "max x max": (32, 128, 127, 127, 0xFF),
}


def _edge_inputs(g, pack, case, m_pad):
    rows, c_pad, qfill, lfill, hfill = EDGE_CASES[case]
    lo, hi = _random_planes(g, pack, m_pad, c_pad)
    qd = g.integers(-128, 128, size=(rows, m_pad), dtype=np.int8)
    if qfill is not None:
        qd[:], lo[:] = qfill, lfill
        if pack:
            hi[:] = hfill
    return qd, lo, hi


@pytest.mark.parametrize("case", list(EDGE_CASES))
@pytest.mark.parametrize("pack", PACKS)
def test_ref_matches_respond_pallas_at_edge_shapes(pack, case, rng):
    """96 digit rows (72 meet hi: not a multiple of 16), the 2^23 planes'
    width, and digits and plane bytes at their extremes (every hi field
    all ones), against K1/K2 interpreted."""
    from chalametpir_tpu.ops.respond_pallas import _run_lo_only, _run_with_hi

    m_pad = 2 * TILE_K
    qd, lo, hi = _edge_inputs(rng, pack, case, m_pad)
    if pack:
        want = [np.asarray(o) for o in _run_with_hi(qd, lo, hi, TILE_K, pack, _bits(pack), True)]
    else:
        want = [np.asarray(_run_lo_only(qd, lo, TILE_K, True))]
    for layout in rd.LAYOUTS:
        out_lo, out_hi = _ref(qd, lo, hi, pack, layout)
        assert np.array_equal(out_lo.numpy(), want[0])
        if pack:
            assert out_hi.shape == (qd.shape[0] - qd.shape[0] // 4, lo.shape[1])
            assert np.array_equal(out_hi.numpy(), want[1])
    if EDGE_CASES[case][2] is not None:  # the closed form of a constant product
        q, l = EDGE_CASES[case][2], EDGE_CASES[case][3]
        assert (want[0] == q * l * m_pad).all()
        if pack:
            field = -1 if pack == 1 else (1 << _bits(pack)) - 1  # pack 1 bytes are read as int8
            assert (want[1] == q * field * m_pad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["2d", "2d-view", "3d"])
@pytest.mark.parametrize("rows", [32, 64, 96])
@pytest.mark.parametrize("pack", PACKS)
def test_digit_kernel_ragged_shapes(pack, rows, layout, cuda):
    """96 digit rows (72 meet hi), 1152 columns (nine blocks of 128), a
    length that leaves a ragged last stage and a ragged last split; the
    2-D digits also as a view of a wider tensor."""
    g = np.random.default_rng(1000 * pack + rows)
    m = 15 * 2048 if layout == "3d" else 30_000  # 30,000 = 468 stages of 64 and 48 rows
    lo, hi = _random_planes(g, pack, m_pad=15 * 2048, c_pad=1152)
    lo_t = torch.from_numpy(lo).to(cuda)
    hi_t = torch.from_numpy(hi).to(cuda) if pack else None
    qd = torch.from_numpy(g.integers(-128, 128, size=(rows, 15 * 2048), dtype=np.int8)).to(cuda)
    if layout == "3d":
        qd_in, qd2 = rd.to_3d(qd), qd
    elif layout == "2d-view":
        qd_in = qd2 = qd[:, :m]
        assert not qd_in.is_contiguous()
    else:
        qd_in = qd2 = qd[:, :m].contiguous()
    want = rd.respond_digits_ref(qd2, lo_t[:m], hi_t[:m] if pack else None, pack)
    got = rd.respond_digits(qd_in, lo_t, hi_t, pack)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    if pack:
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in EDGE_CASES if EDGE_CASES[c][2] is not None])
@pytest.mark.parametrize("pack", PACKS)
def test_digit_kernel_extremes_across_a_split(pack, case, cuda):
    """Digits and plane bytes at their extremes over more rows than one
    split may hold (65,536): every partial sum is the largest it can be."""
    from chalametpir_tpu_torch import kernels

    m = 33 * 2048  # 67,584 > 65,536 + 64
    qd, lo, hi = _edge_inputs(np.random.default_rng(0), pack, case, m)
    geo = kernels.digit_geometry(m, 32, lo.shape[1], pack, 1)  # even on a one-SM card
    assert geo.splits >= 2 and geo.rows_per_split <= kernels.MMA_MAX_SPLIT_ROWS
    qd_t, lo_t = torch.from_numpy(qd).to(cuda), torch.from_numpy(lo).to(cuda)
    hi_t = torch.from_numpy(hi).to(cuda) if pack else None
    q, l = EDGE_CASES[case][2], EDGE_CASES[case][3]
    field = -1 if pack == 1 else (1 << _bits(pack)) - 1
    for qd_in in (qd_t, rd.to_3d(qd_t)):
        out_lo, out_hi = rd.respond_digits(qd_in, lo_t, hi_t, pack)
        assert (out_lo == q * l * m).all()
        if pack:
            assert (out_hi == q * field * m).all()
    want = rd.respond_digits_ref(qd_t, lo_t, hi_t, pack)
    assert torch.equal(out_lo, want[0]) and (not pack or torch.equal(out_hi, want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("pack", PACKS)
def test_digit_kernel_every_tile(pack, cuda):
    """Every block tile the pack allows, forced, against the plain version;
    and the shared memory the host computes is what the kernel asks for."""
    from chalametpir_tpu_torch import kernels

    g = np.random.default_rng(pack)
    lo, hi = _random_planes(g, pack, m_pad=5 * 2048, c_pad=1152)
    lo_t = torch.from_numpy(lo).to(cuda)
    hi_t = torch.from_numpy(hi).to(cuda) if pack else None
    qd = torch.from_numpy(g.integers(-128, 128, size=(96, lo.shape[0]), dtype=np.int8)).to(cuda)
    want = rd.respond_digits_ref(qd, lo_t, hi_t, pack)
    kernels.build()
    for tile in kernels.digit_tiles(pack):
        assert kernels._lib.respond_digits_smem_bytes(pack, *tile) == kernels.digit_smem_bytes(pack, *tile)
        for waves in (1, 3):
            out_lo = torch.zeros((96, 1152), dtype=torch.int32, device=cuda)
            out_hi = torch.zeros((72, 1152), dtype=torch.int32, device=cuda) if pack else None
            kernels._respond_digits(qd, lo_t, hi_t, pack, out_lo, out_hi, tile, waves)
            kernels._respond_digits(rd.to_3d(qd), lo_t, hi_t, pack, out_lo, out_hi, tile, waves)
            torch.cuda.synchronize()
            # accumulated into twice: two's-complement doubling mod 2^32
            assert torch.equal(out_lo, want[0] * 2), (tile, waves)
            if pack:
                assert torch.equal(out_hi, want[1] * 2), (tile, waves)


@pytest.mark.cuda
@pytest.mark.parametrize("what", list(VIOLATIONS))
def test_wrapper_checks_on_the_card(what, cuda):
    """The launcher raises on each contract violation before any launch."""
    from chalametpir_tpu_torch import kernels

    args = _launch_args(device=cuda)
    VIOLATIONS[what](args)
    before = kernels.LAUNCHES["respond_digits"]
    with pytest.raises(ValueError):
        kernels.respond_digits(**args)
    assert kernels.LAUNCHES["respond_digits"] == before


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
