"""The fused s . A over ctr A (chalametpir_tpu_torch/ops/prg_torch.py
`ctr_sa`, csrc/ctr_keccak_sa.cu), which the streaming engine launches
once per kernels.SA_MAX_Q secrets of a batch. On the CPU the plain
version against the JAX package's StreamingQueryEngine and the native
ternary matvec over the whole m_out width; on the card (`cuda`) the
kernel against the plain version and the resident engine's K3 planes,
and the launch counts. s . A is u32 integers: the tolerance is exact
equality.

The JAX reference is imported inside the tests that use it, so the
`cuda` tier (`make check-cuda`) also runs on a GPU host without jax."""

import numpy as np
import pytest
import torch

from chalametpir_tpu_torch import kernels
from chalametpir_tpu_torch.core import prg
from chalametpir_tpu_torch.native import engine as native
from chalametpir_tpu_torch.ops import client_device, prg_torch
from chalametpir_tpu_torch.ops.client_device import DeviceQueryEngine, StreamingQueryEngine
from chalametpir_tpu_torch.params import LWE_DIMENSION

torch.set_num_threads(1)

# the first columns whose first word passes 2^32 bytes and 2^32 words
PAST_2P32_BYTES = -(-(1 << 32) // (4 * LWE_DIMENSION))  # 605,266
PAST_2P32_WORDS = -(-(1 << 32) // LWE_DIMENSION)  # 2,421,064


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (make check-cuda on a GPU host)")
    return torch.device("cuda")


def _codes(g: np.random.Generator, q: int) -> np.ndarray:
    return g.integers(0, 3, size=(q, LWE_DIMENSION)).astype(np.int8)


def _signs(codes: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.where(codes == 2, -1, codes).astype(np.int8)).to(device)


def _u32(t) -> np.ndarray:
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t).view(np.uint32)


def _windowed_ref(seed_words, signs: torch.Tensor, col0: int, ncols: int) -> np.ndarray:
    """signs . A[:, col0 : col0 + ncols] by the slab the K3 path expands
    (`expand_fp_slab`) and one int64 product on the CPU."""
    slab = prg_torch.expand_fp_slab(seed_words, col0, ncols, LWE_DIMENSION, "cpu").to(torch.int64) & 0xFFFFFFFF
    return ((signs.cpu().to(torch.int64) @ slab.T) & 0xFFFFFFFF).numpy().astype(np.uint32)


@pytest.mark.parametrize("m", [96, 300, 1000])
@pytest.mark.parametrize("q", [1, 3, kernels.SA_MAX_Q, kernels.SA_MAX_Q + 1])
def test_plain_sa_matches_jax_streaming_and_native(q, m, rng):
    """The plain version and the CPU engine over the whole m_out width,
    the PRG columns past m included, against the JAX streaming engine
    asked for m_out columns and the native ternary matvec over A's m_out
    columns."""
    from chalametpir_tpu.ops.client_device import StreamingQueryEngine as JaxStreaming

    seed = rng.bytes(32)
    codes = _codes(rng, q)
    m_out = -(-m // 8) * 8
    got = _u32(prg_torch.ctr_sa(prg_torch.seed_to_words(seed), _signs(codes), 0, m_out, LWE_DIMENSION))
    assert got.shape == (q, m_out)
    a = prg.expand_seed(LWE_DIMENSION, m_out, seed, mode="ctr")
    assert np.array_equal(got, np.stack([native.ternary_matvec(c, a) for c in codes]))
    assert np.array_equal(got, JaxStreaming(seed, m_out, cols_per_step=256).matvec_batch(codes))
    engine = StreamingQueryEngine(seed, m, device="cpu", cols_per_step=128)
    assert np.array_equal(np.asarray(engine.matvec_batch_async(codes)), got)


@pytest.mark.parametrize("col0", [0, 21, 22, PAST_2P32_BYTES - 3, PAST_2P32_WORDS - 3])
def test_plain_sa_over_a_window_of_columns(col0, rng):
    """A window of columns from col0: column 21's first word starts a ctr
    block (21 * 1774 = 887 * 42), 22's does not; the last two windows
    cross 2^32 bytes and 2^32 words of the stream."""
    seed_words = prg_torch.seed_to_words(rng.bytes(32))
    signs = _signs(_codes(rng, 2))
    got = _u32(prg_torch.ctr_sa(seed_words, signs, col0, 7, LWE_DIMENSION))
    assert np.array_equal(got, _windowed_ref(seed_words, signs, col0, 7))


def test_ctr_sa_rejects_bad_inputs():
    words = prg_torch.seed_to_words(bytes(32))
    with pytest.raises(ValueError):
        prg_torch.ctr_sa(words, torch.zeros((1, LWE_DIMENSION - 1), dtype=torch.int8), 0, 8, LWE_DIMENSION)
    with pytest.raises(ValueError):
        prg_torch.ctr_sa(words, torch.zeros((1, LWE_DIMENSION), dtype=torch.int32), 0, 8, LWE_DIMENSION)
    # the kernel's wrapper takes CUDA tensors alone
    with pytest.raises(ValueError, match="CUDA"):
        kernels.ctr_keccak_sa(torch.zeros((1, 8), dtype=torch.int32), (0, 0, 0, 0),
                              torch.zeros((1, LWE_DIMENSION), dtype=torch.int8), 0)


@pytest.mark.parametrize("q", [1, kernels.SA_MAX_Q, kernels.SA_MAX_Q + 1, 2 * kernels.SA_MAX_Q + 1])
def test_the_engine_makes_one_fused_call_a_batch(q, rng, monkeypatch):
    """Any batch is one fused s . A over all m_out columns, whatever
    cols_per_step, and no K3 slab; the launch span's count is a launch
    per kernels.SA_MAX_Q secrets."""
    m = 300
    calls = {"sa": [], "slabs": []}
    sa, expand = prg_torch.ctr_sa, prg_torch.expand_fp_slab

    def counted_sa(*args):
        calls["sa"].append((args[1].shape[0],) + args[2:4])
        return sa(*args)

    def counted_expand(*args):
        calls["slabs"].append(args[1])
        return expand(*args)

    monkeypatch.setattr(client_device.prg_torch, "ctr_sa", counted_sa)
    monkeypatch.setattr(client_device.prg_torch, "expand_fp_slab", counted_expand)
    engine = StreamingQueryEngine(rng.bytes(32), m, device="cpu", cols_per_step=128)
    engine.matvec_batch_async(_codes(rng, q))
    assert calls == {"sa": [(q, 0, 304)], "slabs": []}
    assert engine.fused_launches(q) == -(-q // kernels.SA_MAX_Q)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 2, 3, 8, 9, 17, kernels.SA_MAX_Q, kernels.SA_MAX_Q + 1, 2 * kernels.SA_MAX_Q + 1])
def test_kernel_matches_plain_and_the_resident_engine(q, cuda):
    """The kernel at m = 20011 against the plain version on the card and
    on the host and against the resident engine (K3's planes and
    torch._int_mm), over every m_out column (a column whose first word
    starts a ctr block every 21 columns, the others not), at each of its
    instantiations' edges and past one launch."""
    g = np.random.default_rng(20 + q)
    m = 20011
    m_out = -(-m // 8) * 8
    seed = g.bytes(32)
    words = prg_torch.seed_to_words(seed)
    codes = _codes(g, q)
    signs = _signs(codes, cuda)
    got = prg_torch.ctr_sa(words, signs, 0, m_out, LWE_DIMENSION)
    assert got.shape == (q, m_out) and got.device.type == "cuda"
    assert torch.equal(got, prg_torch.ctr_sa_ref(words, signs, 0, m_out, LWE_DIMENSION))
    assert np.array_equal(_u32(got), _u32(prg_torch.ctr_sa(words, signs.cpu(), 0, m_out, LWE_DIMENSION)))
    resident = DeviceQueryEngine.from_seed_ctr(seed, m, cols_per_step=4096, device=cuda)
    assert np.array_equal(_u32(got), np.asarray(resident.matvec_batch_async(codes)))


@pytest.mark.cuda
@pytest.mark.parametrize("col0", [21, 22, PAST_2P32_BYTES - 100, PAST_2P32_WORDS - 100, PAST_2P32_WORDS + 12345])
def test_kernel_over_a_window_of_columns(col0, cuda):
    """The wrapper's column offset: windows from a block-aligned column
    (21) and a column that is not (22), and windows across 2^32 bytes and
    2^32 words of the stream and past them, into an out view with a row
    stride of its own."""
    g = np.random.default_rng(col0)
    words = prg_torch.seed_to_words(g.bytes(32))
    signs = _signs(_codes(g, 3), cuda)
    ncols = 1000
    got = prg_torch.ctr_sa(words, signs, col0, ncols, LWE_DIMENSION)
    assert np.array_equal(_u32(got), _u32(prg_torch.ctr_sa_ref(words, signs, col0, ncols, LWE_DIMENSION)))
    assert np.array_equal(_u32(got[:, :40]), _windowed_ref(words, signs, col0, 40))
    wide = torch.full((3, ncols + 24), -1, dtype=torch.int32, device=cuda)
    kernels.ctr_keccak_sa(wide[:, 8 : 8 + ncols], prg_torch._seed_lanes(words), signs, col0)
    assert torch.equal(wide[:, 8 : 8 + ncols], got)
    assert bool((wide[:, :8] == -1).all()) and bool((wide[:, 8 + ncols :] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, kernels.SA_MAX_Q, kernels.SA_MAX_Q + 1, 2 * kernels.SA_MAX_Q + 1])
def test_a_fused_launch_per_sa_max_q_secrets(q, cuda):
    """A fused launch per kernels.SA_MAX_Q secrets and no K3 launch."""
    g = np.random.default_rng(q)
    m = 20011
    engine = StreamingQueryEngine(g.bytes(32), m, device=cuda, cols_per_step=4096)
    before = dict(kernels.LAUNCHES)
    engine.matvec_batch(_codes(g, q))
    moved = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert moved == {"ctr_keccak_sa": -(-q // kernels.SA_MAX_Q)} == {"ctr_keccak_sa": engine.fused_launches(q)}


@pytest.mark.cuda
def test_the_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    lanes = (0, 0, 0, 0)
    out = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    signs = torch.zeros((2, LWE_DIMENSION), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # more secrets than the kernel takes
        kernels.ctr_keccak_sa(torch.zeros((kernels.SA_MAX_Q + 1, 8), dtype=torch.int32, device=cuda), lanes,
                              torch.zeros((kernels.SA_MAX_Q + 1, LWE_DIMENSION), dtype=torch.int8, device=cuda), 0)
    with pytest.raises(ValueError):  # out's rows are not the secrets'
        kernels.ctr_keccak_sa(out[:1], lanes, signs, 0)
    with pytest.raises(ValueError):  # out's columns are strided
        kernels.ctr_keccak_sa(out[:, ::2], lanes, signs, 0)
    with pytest.raises(ValueError):  # signs not int8
        kernels.ctr_keccak_sa(out, lanes, signs.to(torch.int32), 0)
    with pytest.raises(ValueError):  # signs not contiguous
        kernels.ctr_keccak_sa(out, lanes, torch.zeros((LWE_DIMENSION, 2), dtype=torch.int8, device=cuda).t(), 0)
    with pytest.raises(ValueError):  # words past 2^64
        kernels.ctr_keccak_sa(out, lanes, signs, 1 << 62)
